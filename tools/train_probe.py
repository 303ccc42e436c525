#!/usr/bin/env python3
"""Probe of the guarded training path's two assumptions, on one GPU.

    python3 tools/train_probe.py

1. The training step is bitwise deterministic on the card: full-width
   olmo-1b (2 layers, then all 16), batch 4 x seq 512 on ``cuda_fused``,
   computes its gradients twice on one batch, and runs two steps twice
   from cloned states; prints whether losses, gradients and parameters
   agree bitwise. A rollback's replay can repeat its losses bitwise only
   if they do.
2. The rates a checkpoint runs at: 2.4 GB of f32 (a 2-layer commit's
   size) copied from the card (D2H), hashed with CRC32, written with
   ``np.savez`` and read back with ``np.load``, in a temporary directory
   under ``build/`` that is deleted after.

Prints the card's name and power limit, and the free space of the disk
the checkpoints go to.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def determinism(layers: int) -> None:
    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_grads_fn
    from repro_torch.launch.train import build

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=layers)
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    params, opt, step = build(cfg, tcfg, "cuda")
    tokens = torch.from_numpy(SyntheticLM(cfg.vocab_size, 512, 4, seed=1).next()["tokens"]).cuda()
    grads_fn = make_grads_fn(cfg, tcfg)
    g1, l1 = grads_fn(params, {"tokens": tokens})
    g2, l2 = grads_fn(params, {"tokens": tokens})
    differ = [i for i, (a, b) in enumerate(zip(g1, g2)) if not torch.equal(a, b)]
    print(f"{layers} layers: loss {float(l1)!r} vs {float(l2)!r}; gradient leaves that differ: "
          f"{len(differ)} of {len(g1)}")
    del g1, g2
    leaves = R.tree_leaves(params)
    snap = [p.detach().clone() for p in leaves]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for p, s in zip(leaves, snap):
                p.copy_(s)
        o = type(opt)(step=opt.step.clone(), m=[m.clone() for m in opt.m],
                      v=[v.clone() for v in opt.v])
        _, o, m1 = step(params, o, {"tokens": tokens})
        _, o, m2 = step(params, o, {"tokens": tokens})
        runs.append(([p.detach().clone() for p in leaves], float(m1["loss"]), float(m2["loss"])))
    same = all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    print(f"{layers} layers: two steps twice from one state: parameters bitwise equal {same}; "
          f"losses {runs[0][1:]} and {runs[1][1:]}")


def checkpoint_rates() -> None:
    import numpy as np
    import torch

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_probe_", dir=os.path.join(ROOT, "build"))
    try:
        arrs = {f"a{i}": np.random.default_rng(i).standard_normal(60_000_000).astype(np.float32)
                for i in range(10)}
        nbytes = sum(a.nbytes for a in arrs.values())
        t0 = time.time()
        for a in arrs.values():
            zlib.crc32(a.tobytes())
        t1 = time.time()
        np.savez(os.path.join(d, "s.npz"), **arrs)
        t2 = time.time()
        os.sync()
        t3 = time.time()
        with np.load(os.path.join(d, "s.npz")) as z:
            back = {k: z[k] for k in z.files}
        t4 = time.time()
        del back
        print(f"{nbytes / 1e9:.2f} GB: crc {t1 - t0:.2f} s, savez {t2 - t1:.2f} s, sync "
              f"{t3 - t2:.2f} s, load {t4 - t3:.2f} s")
        x = torch.randn(60_000_000 * 10, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        x.to("cpu")
        print(f"D2H {x.numel() * 4 / 1e9:.2f} GB {time.time() - t0:.2f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(subprocess.run(["df", "-h", ROOT], capture_output=True, text=True).stdout)
    from repro_torch import reduce as R
    from repro_torch.kernels import build

    t0 = time.time()
    build.library()
    print(f"kernel build {time.time() - t0:.1f} s")
    R.set_default_backend("cuda_fused")
    for layers in (2, 16):
        determinism(layers)
        torch.cuda.empty_cache()
    checkpoint_rates()
    return 0


if __name__ == "__main__":
    sys.exit(main())
