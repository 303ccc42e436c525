"""Quickstart: the paper's MMA reduction as a library, then a tiny LM
trained with every reduction of its step on the MMAs.

Port of ``examples/quickstart.py``. Section 1 reduces 2^20 seeded Gaussian
numbers with ``core.mma_reduce.mma_sum`` (eq. 13, its trace's levels and
model steps against eq. 16), with ``reduce(backend="cuda_fused")`` (the
one-launch kernel, K1), with the paper's classic pairwise tree, and
prints the modelled speedup S(m = 128) of eq. 17. Section 2 trains tiny
olmo-1b (non-parametric LayerNorm: the norms are pure MMA statistics) for
10 steps at lr 3e-3 on one seeded batch and prints the loss and the
clip statistic's gradient norm.

  python -m repro_torch.examples.quickstart              # on the card
  python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs import TINY_ARCHS, TrainConfig
from repro_torch.core import cost_model
from repro_torch.core.mma_reduce import classic_tree_sum, mma_sum
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params

N = 1 << 20
STEPS, BATCH, SEQ = 10, 4, 64


def reduction_section(device) -> dict:
    x = torch.from_numpy(np.random.RandomState(0).randn(N).astype(np.float32)).to(device)
    trace = []
    total = mma_sum(x, m=128, trace=trace)
    print(f"mma_sum            = {float(total):.4f}  (levels={trace[0].levels}, model "
          f"steps={trace[0].model_steps}, T_tc eq.16={trace[0].predicted_steps:.1f})")
    total_k = R.reduce(x, backend="cuda_fused")
    print(f"reduce cuda_fused  = {float(total_k):.4f}  (one launch, lanes folded in it)")
    classic = classic_tree_sum(x)
    print(f"classic_tree_sum   = {float(classic):.4f}  (paper's 4log2(n) baseline)")
    speedup = cost_model.speedup_model(128)
    print(f"model speedup S(m=128) = {speedup:.1f}x  (eq. 17)\n")
    return {"mma_sum": float(total), "reduce": float(total_k), "classic": float(classic),
            "levels": trace[0].levels, "speedup": speedup}


def training_section(device) -> list:
    cfg = TINY_ARCHS["olmo-1b"]  # non-parametric LN: pure MMA statistics
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    opt = optim.init_state(params)
    step = make_train_step(cfg, TrainConfig(learning_rate=3e-3, total_steps=30, warmup_steps=3))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, SEQ))
                            ).to(device)
    losses = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, {"tokens": toks})
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            print(f"step {i}: loss={losses[-1]:.4f} grad_norm(MMA)={float(m['grad_norm']):.3f}")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU when unset")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = reduction_section(device)
    out["losses"] = training_section(device)
    print("\nquickstart OK")
    return out


if __name__ == "__main__":
    main()
