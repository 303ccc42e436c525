"""The paper end to end on the card: encode a reduction of n numbers as
all-ones MMAs, count its steps against eqs. 16-17, measure the precision
lost at low multiplier widths, and time each backend.

Port of ``examples/reduce_demo.py`` and of section 1 of
``examples/quickstart.py``. Runs on the GPU unless given ``--device cpu``;
with no GPU and no ``--device`` it raises.

  python -m repro_torch.launch.reduce_demo                 # n = 2^28 on the card
  python -m repro_torch.launch.reduce_demo --device cpu --n 65536

Three tables:

  1. step counts: for m = 4, 16 (``mma_torch``) and 128 (the level kernel,
     ``cuda_hier``), the levels and model steps of the hierarchy's trace,
     T_tc by eq. 16, the classic 4 log2 n, and S measured against eq. 17;
  2. precision: relative error against an f64 sum of n Gaussian f32
     numbers, for bf16 / f16 / f32 multipliers on the hierarchy, the
     classic pairwise sum, ``blocked_kahan_mma``, and ``cuda_fused``
     without and with ``precision="kahan"`` (f32 multipliers, so only the
     carry differs);
  3. time per call of each backend on the same numbers (CUDA events on the
     card, the card's name and power limit beside them; on the CPU the
     host clock, which is no device time).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch import reduce as R
from repro_torch.core import cost_model, precision
from repro_torch.core.mma_reduce import classic_tree_sum, mma_sum
from repro_torch.kernels.mma_reduce import mma_sum_hier
from repro_torch.launch.serve import resolve_device

STEP_MS = (4, 16, 128)
MULTIPLIERS = (("bf16", torch.bfloat16), ("f16", torch.float16), ("f32", torch.float32))
TIMED = (
    ("torch", dict(backend="torch")),
    ("mma_torch", dict(backend="mma_torch")),
    ("cuda_hier", dict(backend="cuda_hier")),
    ("cuda_fused", dict(backend="cuda_fused")),
    ("cuda_fused+kahan", dict(backend="cuda_fused", precision="kahan")),
    ("moments (cuda_fused)", dict(backend="cuda_fused", kind="moments")),
)


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    host for a CPU run."""
    if device.type != "cuda":
        return "host CPU (host clock; not a device time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def step_table(n_max: int, device, gen) -> list:
    """Rows (n, m, levels, model steps, eq. 16, classic steps, S measured,
    S eq. 17) for n = (m^2)^k, k = 1, 2, up to ``n_max``."""
    rows = []
    for m in STEP_MS:
        for k in (1, 2):
            n = (m * m) ** k
            if n > n_max:
                continue
            x = torch.randn((n,), generator=gen, device=device)
            tr, tc = [], []
            if m == 128:
                mma_sum_hier(x, trace=tr)  # the level kernel, one launch per level
            else:
                mma_sum(x, m=m, trace=tr)
            classic_tree_sum(x, trace=tc)
            rows.append((n, m, tr[0].levels, tr[0].model_steps, cost_model.t_tensor_core(n, m),
                         4 * tc[0].levels, 4 * tc[0].levels / tr[0].model_steps,
                         cost_model.speedup_model(m)))
    return rows


def precision_table(x: torch.Tensor) -> list:
    """(name, value, relative error against the f64 sum) rows."""
    exact = float(x.double().sum())
    rows = [(f"mma {name} multipliers, f32 accum (cuda_hier)",
             R.reduce(x, backend="cuda_hier", compute_dtype=dt)) for name, dt in MULTIPLIERS]
    rows += [
        ("classic pairwise f32", classic_tree_sum(x)),
        ("blocked Kahan + MMA (Markidis-style)", precision.blocked_kahan_mma(x)),
        ("cuda_fused f32 multipliers, native", R.reduce(x, backend="cuda_fused",
                                                        compute_dtype=torch.float32)),
        ("cuda_fused f32 multipliers, kahan", R.reduce(x, backend="cuda_fused",
                                                       compute_dtype=torch.float32,
                                                       precision="kahan")),
    ]
    return [(name, float(v), precision.relative_error(v, exact)) for name, v in rows]


def time_per_call(fn, device, iters: int) -> float:
    """Mean ms per call: CUDA events around ``iters`` back-to-back calls
    after a warm-up on the card; the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_table(x: torch.Tensor, iters: int) -> list:
    rows = []
    for name, kw in TIMED:
        kw = dict(kw)
        kind = kw.pop("kind", "sum")
        rows.append((name, time_per_call(lambda: R.reduce(x, kind=kind, **kw), x.device, iters)))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 28, help="numbers reduced (default 2^28)")
    ap.add_argument("--device", default=None, help="cpu, or the GPU when unset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10, help="calls per timing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    label = card_label(device)

    print("=== step counts: T_tc(n) = 5 log_{m^2}(n)   [eq. 15-16] ===")
    print(f"{'n':>10} {'m':>4} {'levels':>7} {'steps':>6} {'eq16':>6} {'classic':>8} "
          f"{'S meas':>7} {'S eq17':>7}")
    steps = step_table(args.n, device, gen)
    for n, m, lv, st, eq16, cl, s_meas, s17 in steps:
        print(f"{n:>10} {m:>4} {lv:>7} {st:>6} {eq16:>6.1f} {cl:>8} {s_meas:>7.2f} {s17:>7.2f}")

    x = torch.randn((args.n,), generator=gen, device=device)
    print(f"\n=== precision loss against the f64 sum, n = {args.n} f32 ===")
    prec = precision_table(x)
    for name, _, rel in prec:
        print(f"  {name:44s} rel err = {rel:.3e}")

    print(f"\n=== time per call, n = {args.n} f32 ({label}) ===")
    times = time_table(x, args.iters)
    for name, ms in times:
        print(f"  {name:24s} {ms * 1e3:12.2f} us")
    return {"steps": steps, "precision": prec, "times": times, "device": label}


if __name__ == "__main__":
    main()
