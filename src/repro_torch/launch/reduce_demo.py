"""The paper end to end on the card: encode a reduction of n numbers as
all-ones MMAs, count its steps against eqs. 16-17, measure the precision
lost at low multiplier widths, and time each backend.

Port of ``examples/reduce_demo.py`` and of section 1 of
``examples/quickstart.py``. Runs on the GPU unless given ``--device cpu``;
with no GPU and no ``--device`` it raises.

  python -m repro_torch.launch.reduce_demo                 # n = 2^28 on the card
  python -m repro_torch.launch.reduce_demo --device cpu --n 65536

Four tables:

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
     host clock, which is no device time);
  4. the segmented multi-reduce (the reference demo's section): three
     segments through ``reduce_many(kind="sumsq")`` against f64, and the
     plan line; then the n numbers as 2048 packed segments of seeded ragged
     lengths (two empty in the middle, boundaries off the tile grid)
     through ``reduce_many`` on ``cuda_fused`` -- the pack and ONE launch
     of the gather kernel -- with the worst error against the f64 segment
     sums relative to each segment's mass, and the time per call;
  5. where it lands on the card (the reference demo's last section, for
     its TPU): ``core.cost_model.gpu_reduction_roofline`` for n = 2^16,
     2^24, 2^28 and m = 16 (the paper's Volta tile), 128 (the port's):
     the stream at bf16 and f32, the classic tree on the CUDA cores, the
     MMA encoding on the tensor cores, and whether the encoding is
     bandwidth-neutral; then ``cuda_fused`` (K1) and ``cuda_hier`` (K10)
     timed on the n numbers at f32 and at bf16, each as a share of its
     cold bound at m = 128 (a share under 1 would beat the card).
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
ROOFLINE_NS = (1 << 16, 1 << 24, 1 << 28)
ROOFLINE_MS = (16, 128)
MEASURED = (("cuda_fused", "K1"), ("cuda_hier", "K10"))
SEGMENTS = 2048  # packed documents in the segmented table
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


def packed_offsets(n: int, count: int = SEGMENTS, seed: int = 0) -> np.ndarray:
    """Offsets of ``count`` ragged segments that pack n numbers: seeded
    random boundaries (off the 16384-element tile grid, almost surely), the
    first segment and two in the middle empty."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, n, size=count - 1))
    for i in (count // 3, 2 * count // 3):
        cuts[i] = cuts[i - 1]
    offsets = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    offsets[1] = 0
    return offsets


def segmented_table(x: torch.Tensor, iters: int, seed: int) -> dict:
    """The reference demo's three segments, then ``x`` as packed segments
    through ``reduce_many`` on ``cuda_fused``."""
    gen = np.random.default_rng(seed)
    segs = [torch.from_numpy(gen.standard_normal(k).astype(np.float32)).to(x.device)
            for k in (33, 1000, 16385)]
    batched = R.reduce_many(segs, kind="sumsq")
    three = []
    for a, got in zip(segs, batched.tolist()):
        exact = float((a.double() ** 2).sum())
        three.append((a.numel(), got, exact))
        print(f"  segment n={a.numel():>6}: batched={got:12.4f} exact={exact:12.4f}")
    plan = R.plan_for((sum(a.numel() for a in segs),), torch.float32, kind="sumsq",
                      segments=len(segs))
    print("  plan:", plan)
    offsets = packed_offsets(x.numel(), min(SEGMENTS, x.numel()), seed)
    parts = list(torch.split(x, np.diff(offsets).tolist()))
    got = R.reduce_many(parts, backend="cuda_fused").double()
    ids = torch.repeat_interleave(torch.arange(len(parts), device=x.device),
                                  torch.from_numpy(np.diff(offsets)).to(x.device))
    exact = torch.zeros(len(parts), dtype=torch.float64, device=x.device).index_add_(
        0, ids, x.double())
    mass = torch.zeros_like(exact).index_add_(0, ids, x.double().abs())
    worst = float(((got - exact).abs() / mass.clamp_min(1e-30)).max())
    ms = time_per_call(lambda: R.reduce_many(parts, backend="cuda_fused"), x.device, iters)
    print(f"  {len(parts)} packed segments of n = {x.numel()} f32 (reduce_many, cuda_fused, "
          f"bf16 multipliers): worst |error| / segment mass vs f64 {worst:.3e}; "
          f"{ms * 1e3:.2f} us per call")
    return {"three": three, "plan": plan, "count": len(parts), "worst_rel_to_mass": worst,
            "ms": ms, "offsets": offsets}


def roofline_table(ns=ROOFLINE_NS, ms=ROOFLINE_MS) -> list:
    """(n, m, the bf16 roofline, the f32 roofline) rows
    (``cost_model.ReductionRoofline``; only the stream differs)."""
    return [(n, m, cost_model.gpu_reduction_roofline(n, 2, m=m),
             cost_model.gpu_reduction_roofline(n, 4, m=m)) for n in ns for m in ms]


def measured_against_roofline(x: torch.Tensor, iters: int) -> list:
    """(backend, kernel, dtype, ms per call, cold bound ms, share) rows: the
    full sum of ``x`` at f32 and rounded to bf16 on each of ``MEASURED``'s
    backends, against ``gpu_reduction_roofline(n, itemsize).cold_bound_s``
    at the kernels' m = 128."""
    rows = []
    for xd in (x, x.to(torch.bfloat16)):
        roofline = cost_model.gpu_reduction_roofline(xd.numel(), xd.element_size())
        bound_ms = roofline.cold_bound_s * 1e3
        for backend, kernel in MEASURED:
            ms = time_per_call(lambda: R.reduce(xd, backend=backend), xd.device, iters)
            rows.append((backend, kernel, str(xd.dtype).replace("torch.", ""), ms, bound_ms,
                         ms / bound_ms))
        del xd
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

    print(f"\n=== segmented multi-reduce: N reductions, ONE pass ({label}) ===")
    segments = segmented_table(x, args.iters, args.seed)

    print(f"\n=== where it lands on the card ({cost_model.CARD}: "
          f"{cost_model.HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{cost_model.BF16_TENSOR_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16 tensor, {cost_model.F32_CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s f32) ===")
    print(f"{'n':>10} {'m':>4} {'HBM bf16':>10} {'HBM f32':>10} {'CUDA core':>10} "
          f"{'tensor':>10} {'neutral bf16/f32':>17}   (us)")
    roofline = roofline_table()
    for n, m, r2, r4 in roofline:
        print(f"{n:>10} {m:>4} {r2.hbm_s * 1e6:>10.3f} {r4.hbm_s * 1e6:>10.3f} "
              f"{r2.cuda_core_s * 1e6:>10.3f} {r2.tensor_core_s * 1e6:>10.3f} "
              f"{str(r2.tensor_core_bandwidth_neutral):>8}/"
              f"{str(r4.tensor_core_bandwidth_neutral):<8}")
    measured = measured_against_roofline(x, args.iters)
    for backend, kernel, dt, ms, bound, share in measured:
        print(f"  {backend} ({kernel}) at n = {args.n} {dt}: {ms * 1e3:.2f} us per call, cold "
              f"bound {bound * 1e3:.2f} us, share {share:.3f} ({label})")
    print("cold reductions are bound by the stream; the MMA encoding's work fits under it at "
          "m = 128, and frees the CUDA cores inside fused kernels (norms, softmax, CE)")
    return {"steps": steps, "precision": prec, "times": times, "segments": segments,
            "roofline": roofline, "measured": measured, "device": label}


if __name__ == "__main__":
    main()
