"""End-to-end training of a ~100M-parameter llama-family model.

Port of ``examples/train_100m.py``: ``llama-110m`` (12 layers x 768, 12
MHA heads of 64, d_ff 3072, vocab 32000, RMSNorm, f32) trained on the
seeded ``SyntheticLM`` stream through ``Prefetcher``, with AdamW at lr
6e-4 after a warm-up of 1/20 of the steps. On the card every hot spot
runs on its kernel: the norms (K5b), the attention at 12 heads of 64 (K6,
on the bf16-rounded operands the reference's attention rounds to), the
cross-entropy over the 32 000 columns (K7), the loss's token sum (K1, the
``cuda_fused`` reduce backend) and the clip statistic over the 111
gradient leaves (one K4 launch).

  python -m repro_torch.examples.train_100m               # 300 x 8 x 512 on the card
  python -m repro_torch.examples.train_100m --smoke --device cpu

``--smoke`` trains the reference's reduced sibling (2 layers x 128, vocab
2048) for at most 6 steps of 4 x 128. The run checks that the last loss
is below the first, as the reference does. ``run(cfg, params, steps,
batch, seq, device)`` is the loop without the CLI (a caller may pass
weights of its own, such as the reference's carried across by
``models.convert.params_from_jax``).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import Prefetcher, ShardInfo, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.params import count_params

# ~110M params: 12L x 768, GPT-2-small-shaped llama-style stack
CFG_100M = ModelConfig(
    name="llama-110m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_head=64, d_ff=3072, vocab_size=32000, norm="rmsnorm",
    dtype="float32",
)
SMOKE_CFG = dataclasses.replace(CFG_100M, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                                d_head=32, d_ff=512, vocab_size=2048, name="llama-110m-smoke")
SMOKE_STEPS, SMOKE_BATCH, SMOKE_SEQ = 6, 4, 128
DATA_SEED = 0
PARAM_SEED = 0
# The reduce backend of the CLI's runs: the loss's token sum on K1 (the
# clip statistic takes the config flags' cuda_fused either way).
REDUCE_BACKEND = "cuda_fused"


def train_config(steps: int) -> TrainConfig:
    return TrainConfig(learning_rate=6e-4, total_steps=steps, warmup_steps=max(1, steps // 20))


def run(cfg, params=None, steps: int = 300, batch: int = 8, seq: int = 512, device="cuda", *,
        walls: list | None = None) -> list:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` from ``params`` (seeded random when None; they are set to
    require grad and update in place). Prints the loss every tenth of the
    run, the losses' ends and the step wall's median; appends each step's
    wall seconds (the loss read back included) to ``walls``. Returns the
    loss of every step."""
    device = torch.device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(PARAM_SEED), device)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    print(f"{cfg.name}: {count_params(params) / 1e6:.1f}M params, {steps} steps, "
          f"batch {batch} x seq {seq}, {device}")
    tcfg = train_config(steps)
    step = make_train_step(cfg, tcfg)
    opt = optim.init_state(params)
    data = Prefetcher(SyntheticLM(cfg.vocab_size, seq, batch, ShardInfo(), seed=DATA_SEED))
    walls = [] if walls is None else walls
    losses = []
    try:
        for i in range(steps):
            tokens = torch.from_numpy(data.next()["tokens"]).to(device)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": tokens})
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
            if (i + 1) % max(1, steps // 10) == 0:
                print(f"step {i + 1:4d}  loss {losses[-1]:.4f}")
    finally:
        data.close()
    p50 = statistics.median(walls[-steps:])
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; step wall p50 {p50 * 1e3:.2f} ms "
          f"({1 / p50:.2f} steps/s)")
    return losses


def main(argv=None, *, walls: list | None = None) -> list:
    """Run the CLI; ``walls`` as ``run``'s. Returns the losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or the GPU when unset")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG_100M
    if args.smoke:
        cfg = SMOKE_CFG
        args.steps, args.batch, args.seq = min(args.steps, SMOKE_STEPS), SMOKE_BATCH, SMOKE_SEQ
    earlier = R.set_default_backend(REDUCE_BACKEND)
    try:
        losses = run(cfg, None, args.steps, args.batch, args.seq, device, walls=walls)
    finally:
        R.set_default_backend(earlier)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
