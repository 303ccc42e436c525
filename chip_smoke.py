#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the full-width
shapes of the serving and training paths (olmo-1b: d_model 2048, 16 heads
of 128, vocab 50304 padded to 50432, bf16) and of the paper's reduction
(n = 2^28) and times it, checks tiny and 2-layer models end to end against
the CPU (serving and training) and the reduction engine card against CPU,
then drives the three main paths with every kernel launch counted:

  serving   full-width olmo-1b through the guarded runtime (8 requests,
            prompt 256, 16 new tokens, 4 slots);
  training  full-width olmo-1b, batch 4 x seq 512, 3 AdamW steps through
            ``python -m repro_torch.launch.train``'s ``main`` with
            ``--reduce-backend cuda_fused``; then one step profiled;
  paper     ``python -m repro_torch.launch.reduce_demo``'s ``main`` at
            n = 2^28: step counts, precision and time per backend, through
            the hierarchy's level kernel (K10), the moments kernel (K2)
            and the Kahan kernel (K3), and its segmented section;
  multi     the multi-reduce and scan path: ``reduce_many`` over 2^28 f32
            values in 2048 packed ragged segments (the pack and one launch
            of the gather kernel, K8), ``reduce_many`` kinds sum and
            moments over full-width olmo-1b's 113 parameter leaves (the
            parts kernel, K4, at bf16 compute), ``repro_torch.scan`` over
            2^28 f32 and bf16 values (the scan kernel, K9) and
            ``packing_offsets`` of 2048 lengths on ``cuda_fused``;
  matmul    the K11 entry, ``repro_torch.kernels.matmul_stats``, at
            olmo-1b's MLP down projection, (2048 x 8192) @ (8192 x 2048)
            at bf16 and f32 and the serving prefill's 1024 rows at bf16
            (the fused matmul with its row moments, K11).

Exits nonzero, with no result line, when any check fails or there is no
GPU.

Output: the card's name and power limit (nvidia-smi), the build time, one
line per kernel check, the serving, training and paper figures, then the
kernels JSON line (each kernel timed at its main path's shapes: training
for K1/K4-K7, with serving-shape figures under "serving"; the paper's
n = 2^28 f32 for K2, K3, K10, with bf16 figures beside them; "launches"
counts the kernel's own main path; K8 and K9 at 2^28 f32, bf16 beside;
K11 at (2048 x 8192) @ (8192 x 2048) bf16, the serving rows and f32
beside) and, last,
``{"ok": true, "device": {...}}``.

Peak rates used for the bounds are the H100 SXM data sheet's: 3.35 TB/s of
HBM, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
cores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12

# The serving run: full-width olmo-1b, depth as published.
SLOTS, PROMPT, MAX_NEW, REQUESTS = 4, 256, 16, 8
WAVES = -(-REQUESTS // SLOTS)


# The training run: full-width olmo-1b, depth as published.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
LOSS_CHUNK = 512  # models.losses.lm_loss_chunked's seq_chunk


def train_launches_per_step(n_layers: int) -> dict:
    """Kernel launches per training step under remat. Forward: two norms
    per layer plus the final norm, one attention per layer; backward: each
    layer recomputed (two norms, one attention). The chunked loss runs the
    CE kernel in its forward and again in its recompute; the token sum's
    kernel runs once, because its backward reads nothing of its output and
    the recompute stops at the last tensor the backward needs. The clip
    statistic is one parts launch."""
    chunks = -(-TRAIN_SEQ // LOSS_CHUNK)
    return {"layernorm_np": 4 * n_layers + 1, "flash_attention": 2 * n_layers,
            "cross_entropy": 2 * chunks, "mma_sum_fused": chunks, "mma_sum_parts": 1,
            "rmsnorm": 0}


def launches_per_step(n_layers: int):
    """Kernel launches per prefill and per decode step: two norms per layer
    plus the final norm, prefill attention per layer, one logit statistic."""
    prefill = {"layernorm_np": 2 * n_layers + 1, "flash_attention": n_layers,
               "mma_sum_parts": 1}
    decode = dict(prefill, flash_attention=0)
    return prefill, decode


TPU_KERNELS = {
    "tile_partials": "src/repro/kernels/mma_reduce/kernel.py:131",
    "mma_moments_fused": "src/repro/kernels/mma_reduce/kernel.py:257",
    "mma_sum_kahan": "src/repro/kernels/mma_reduce/kernel.py:286",
    "layernorm_np": "src/repro/kernels/row_moments/kernel.py:57",
    "rmsnorm": "src/repro/kernels/row_moments/kernel.py:47",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:50",
    "mma_sum_parts": "src/repro/kernels/mma_reduce/kernel.py:728",
    "cross_entropy": "src/repro/kernels/cross_entropy/kernel.py:39",
    "mma_sum_fused": "src/repro/kernels/mma_reduce/kernel.py:186",
    "mma_sum_segments": "src/repro/kernels/mma_reduce/kernel.py:512",
    "mma_scan": "src/repro/kernels/scan.py:68",
    "matmul_stats": "src/repro/kernels/matmul_stats/kernel.py:29",
}
SOURCES = {
    "tile_partials": "src/repro_torch/kernels/csrc/tile_partials.cu",
    "mma_moments_fused": "src/repro_torch/kernels/csrc/fused_reduce.cu",
    "mma_sum_kahan": "src/repro_torch/kernels/csrc/fused_kahan.cu",
    "layernorm_np": "src/repro_torch/kernels/csrc/row_moments.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/row_moments.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "mma_sum_parts": "src/repro_torch/kernels/csrc/parts_reduce.cu",
    "cross_entropy": "src/repro_torch/kernels/csrc/cross_entropy.cu",
    "mma_sum_fused": "src/repro_torch/kernels/csrc/fused_reduce.cu",
    "mma_sum_segments": "src/repro_torch/kernels/csrc/segmented_gather.cu",
    "mma_scan": "src/repro_torch/kernels/csrc/scan.cu",
    "matmul_stats": "src/repro_torch/kernels/csrc/matmul_stats.cu",
}
KERNELS = ("mma_sum_parts", "layernorm_np", "rmsnorm", "flash_attention", "cross_entropy",
           "mma_sum_fused", "mma_moments_fused", "mma_sum_kahan", "tile_partials",
           "mma_sum_segments", "mma_scan", "matmul_stats")
PAPER_KERNELS = ("mma_moments_fused", "mma_sum_kahan", "tile_partials")
MULTI_KERNELS = ("mma_sum_segments", "mma_scan")
PAPER_N = 2**28  # the reduce demo's n: 1.07 GB of f32


DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one CALL: CUDA events around ``iters`` back-to-back
    calls after ``warmup`` calls. Where the host takes longer to issue a
    call than the device to run it, this is the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0.0))


def device_events(fn, calls: int = 1) -> dict:
    """Run ``fn`` ``calls`` times under the profiler: ``{kernel name:
    (count, device us)}`` of every kernel, memset and copy it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, _self_device_us(e)) for e in prof.key_averages()
            if _self_device_us(e) > 0.0}


def complete_events(fn, expect, calls: int, what: str, tries: int = 3) -> dict:
    """``device_events(fn, calls)`` from a session that lost none of the
    kernels named in ``expect`` (by substring): each ran ``expect[name]``
    times. A session that dropped device events (see ``device_ms``) would
    read short; it is run again, up to ``tries`` in all, then the script
    fails."""
    got = {}
    for attempt in range(1, tries + 1):
        events = device_events(fn, calls)
        got = {name: sum(c for k, (c, _) in events.items() if name in k) for name in expect}
        if events and got == expect:
            return events
        print(f"profiling session {attempt} of {what} is incomplete: kernel counts {got}, "
              f"expected {expect}; run again")
    raise SmokeFailure(f"the profiler lost device events of {what} in {tries} sessions")


def device_ms(fn, match: str | None = None, iters: int = 20, warmup: int = 3,
              tries: int = 3) -> float:
    """Mean DEVICE time of one call: the profiler's device time of every
    kernel, memset and copy the call runs. Inputs stay resident in L2 where
    they fit (at most 17 MB on the serving path), as there, where the
    producer of a kernel's input has just written it.

    A profiling session can drop device events (seen on this card: 1 to 3
    of 5 launches of a 1.5 ms kernel, a few hundred of the ~1800 kernels of
    one plain-version call), and a total divided by the call count then
    reads short. So each device item's time is its mean over the launches
    the profiler did record, times its launches per call: the larger of
    the counts seen in a one-call session and an ``iters``-call session.
    With ``match``, the call must have run a kernel whose name contains
    it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    what = match or getattr(fn, "__qualname__", "the call")
    for attempt in range(1, tries + 1):
        one, many = device_events(fn), device_events(fn, iters)
        if one or many:
            break
        print(f"profiling sessions {attempt} of {what} recorded no device time")
    else:
        raise SmokeFailure(f"the profiler recorded no device time for {what} in {tries} sessions")
    total_us, dropped = 0.0, False
    for key in set(one) | set(many):
        c1, u1 = one.get(key, (0, 0.0))
        cn, un = many.get(key, (0, 0.0))
        per_call = max(c1, cn / iters)
        dropped |= c1 != cn / iters
        total_us += (u1 + un) / (c1 + cn) * per_call
    if dropped:
        print(f"profiling of {what}: launch counts differ between sessions (events dropped); "
              "timed by each item's mean over its recorded launches")
    if match is not None:
        check(any(match in k for k in set(one) | set(many)),
              f"the profiler recorded no device time for a kernel named {match}")
    return total_us / 1e3


def bound_ms(nbytes: float, tensor_flops: float = 0.0, core_flops: float = 0.0):
    """The least time for the work: the larger of bytes over the HBM rate
    and operations over the peak rate of their unit."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tensor_flops / BF16_TENSOR_FLOPS + core_flops / F32_CUDA_CORE_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp_ok(got, want) -> bool:
    """Every element within one bf16 ulp of the plain version's value."""
    import torch

    g, w = got.float(), want.float()
    return bool(torch.all((g - w).abs() <= 2.0**-7 * w.abs() + 1e-6))


# ------------------------------ kernel checks --------------------------------


def check_norms(results: dict, gen) -> None:
    """K5 at decode rows, prefill rows (serving) and the training rows,
    each against its plain version; timed at prefill and training rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import layernorm_np, rmsnorm
    from repro_torch.kernels.row_moments import layernorm_np_plain, rmsnorm_plain

    d = 2048
    rms_lib = getattr(F, "rms_norm", None)
    timed = {}
    for rows in (SLOTS, SLOTS * PROMPT, TRAIN_BATCH * TRAIN_SEQ):
        x = (torch.randn((rows, d), generator=gen, device=DEVICE) * 3 + 1).to(torch.bfloat16)
        gamma = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
        ln, ln_p = layernorm_np(x, 1e-5), layernorm_np_plain(x, 1e-5)
        rn, rn_p = rmsnorm(x, gamma, 1e-6), rmsnorm_plain(x, gamma, 1e-6)
        torch.cuda.synchronize()
        err_ln = float((ln.float() - ln_p.float()).abs().max())
        err_rn = float((rn.float() - rn_p.float()).abs().max())
        print(f"K5a layernorm_np ({rows}, {d}) bf16: max_abs_err {err_ln:.3g} vs plain "
              "(tol: 1 bf16 ulp -- both round x and x*x to bf16 and sum in f32, "
              "in different orders)")
        print(f"K5b rmsnorm      ({rows}, {d}) bf16: max_abs_err {err_rn:.3g} vs plain "
              "(tol: 1 bf16 ulp, same reason)")
        check(bf16_ulp_ok(ln, ln_p), f"layernorm_np disagrees with its plain version at rows={rows}")
        check(bf16_ulp_ok(rn, rn_p), f"rmsnorm disagrees with its plain version at rows={rows}")
        if rows == SLOTS:
            continue
        nbytes = 2 * x.numel() * 2
        mma = x.numel() * 16  # m16n8k16 ones-MMA: 16 flops per element per statistic
        b_ln, by_ln = bound_ms(nbytes, tensor_flops=2 * mma, core_flops=6 * x.numel())
        b_rn, by_rn = bound_ms(nbytes + d * 2, tensor_flops=mma, core_flops=5 * x.numel())
        timed[rows] = {
            "layernorm_np": {
                "max_abs_err": err_ln,
                "ms": device_ms(lambda: layernorm_np(x, 1e-5), "row_norm_kernel"),
                "call_ms": time_ms(lambda: layernorm_np(x, 1e-5)),
                "plain_ms": device_ms(lambda: layernorm_np_plain(x, 1e-5)),
                "bound_ms": b_ln, "bound_by": by_ln,
                "library_ms": device_ms(lambda: F.layer_norm(x, (d,), eps=1e-5)),
            },
            "rmsnorm": {
                "max_abs_err": err_rn,
                "ms": device_ms(lambda: rmsnorm(x, gamma, 1e-6), "row_norm_kernel"),
                "call_ms": time_ms(lambda: rmsnorm(x, gamma, 1e-6)),
                "plain_ms": device_ms(lambda: rmsnorm_plain(x, gamma, 1e-6)),
                "bound_ms": b_rn, "bound_by": by_rn,
                "library_ms": (device_ms(lambda: rms_lib(x, (d,), gamma, 1e-6))
                               if rms_lib is not None else None),
            },
        }
    for name in ("layernorm_np", "rmsnorm"):
        results[name] = dict(timed[TRAIN_BATCH * TRAIN_SEQ][name],
                             serving=timed[SLOTS * PROMPT][name])


def _causal_pairs(sq: int, skv: int, q_offset: int, window) -> int:
    """(query, key) pairs the masks leave visible."""
    n = 0
    for i in range(sq):
        qp = q_offset + i
        lo = 0 if window is None else max(0, qp - window + 1)
        n += max(0, min(qp, skv - 1) - lo + 1)
    return n


def check_attention(results: dict, gen) -> None:
    """K6 against its plain version; timed at the prefill shape (serving)
    and the training shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    cases = [  # b, hq, hkv, sq, skv, d, causal, window, q_offset
        (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, True, None, 0),  # training (timed)
        (SLOTS, 16, 16, PROMPT, PROMPT, 128, True, None, 0),  # the prefill shape (timed)
        (1, 16, 4, 64, 320, 128, True, 128, 256),              # GQA + window + q_offset
        (2, 4, 2, 100, 100, 64, False, None, 0),               # ragged, non-causal
    ]
    timed = {}
    for case in reversed(cases):
        b, hq, hkv, sq, skv, d, causal, window, q_offset = case
        q = (torch.randn((b, hq, sq, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        k = (torch.randn((b, hkv, skv, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        v = (torch.randn((b, hkv, skv, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, plain = flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        print(f"K6 flash_attention {case}: max_abs_err {err:.3g} vs plain "
              "(tol: 2 bf16 ulps of the output -- the same 128-key blocks, f32 sums in "
              "another order, which can flip one bf16 rounding of p)")
        check(bool(torch.isfinite(out.float()).all()), f"flash_attention non-finite at {case}")
        check(bool(torch.all((out.float() - plain.float()).abs()
                             <= 2.0**-6 * plain.float().abs() + 2e-3)),
              f"flash_attention disagrees with its plain version at {case}")
        if case not in cases[:2]:
            continue
        pairs = _causal_pairs(sq, skv, 0, None) * b * hq
        b_fa, by_fa = bound_ms(4 * q.numel() * 2, tensor_flops=4 * d * pairs, core_flops=pairs)
        timed[sq] = {
            "max_abs_err": err,
            "ms": device_ms(lambda: flash_attention(q, k, v, causal=True), "attn_fwd_kernel"),
            "call_ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5),
            "bound_ms": b_fa, "bound_by": by_fa,
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                           is_causal=True)),
        }
    results["flash_attention"] = dict(timed[TRAIN_SEQ], serving=timed[PROMPT])


def check_parts(results: dict, gen) -> None:
    import torch

    from repro_torch.kernels import mma_sum_parts
    from repro_torch.kernels.mma_reduce import mma_sum_parts_plain

    vocab = 50304
    chains = ((),)
    # NaN and Inf planted in two slots: the census must count them exactly
    bad = torch.randn((SLOTS, 1, vocab), generator=gen, device=DEVICE)
    bad[1, 0, 7] = float("nan")
    bad[2, 0, vocab - 1] = float("inf")
    bad[2, 0, 3] = float("-inf")
    row = mma_sum_parts([bad[i] for i in range(SLOTS)], prologue="square",
                        total_chains=chains, census=True)
    again = mma_sum_parts([bad[i] for i in range(SLOTS)], prologue="square",
                          total_chains=chains, census=True)
    check(torch.equal(row.nan_to_num(), again.nan_to_num()),
          "K4: a second launch folds differently (the fold ticket did not reset)")
    counts = row[SLOTS + 1:].tolist()
    print(f"K4 census with NaN/Inf planted: counts {counts}")
    check(counts == [0.0, 1.0, 2.0, 0.0, 3.0], f"K4 census counts wrong: {counts}")
    check(bool(torch.isnan(row[1])) and bool(torch.isinf(row[2])), "K4 poisoned slot sums")

    logits = torch.randn((SLOTS, 1, vocab), generator=gen, device=DEVICE) * 3
    parts = [logits[i] for i in range(SLOTS)]
    out = mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)
    plain = mma_sum_parts_plain(parts, ("square",) * SLOTS, chains, True)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    mass = float(logits.square().sum())
    print(f"K4 mma_sum_parts {SLOTS} x {vocab} f32: max_abs_err {err:.3g} vs plain, "
          f"mass {mass:.4g} (tol: 1e-6 x mass -- f32 sums in another order; counts exact)")
    check(torch.equal(out[SLOTS + 1:], plain[SLOTS + 1:]), "K4 census differs from plain")
    check(err <= 1e-6 * mass, "mma_sum_parts disagrees with its plain version")
    b_k4, by_k4 = bound_ms(logits.numel() * 4 + out.numel() * 4,
                           core_flops=3 * logits.numel())

    def k4():
        return mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)

    results["mma_sum_parts"] = {"serving": {
        "max_abs_err": err,
        "ms": device_ms(k4, "parts_kernel"),
        "call_ms": time_ms(k4),
        "plain_ms": device_ms(lambda: mma_sum_parts_plain(parts, ("square",) * SLOTS, chains,
                                                          True), iters=5),
        "bound_ms": b_k4, "bound_by": by_k4,
        "library_ms": device_ms(lambda: logits.square().sum(-1)),
    }}


def olmo_leaf_shapes(cfg) -> list:
    """Shapes of olmo's parameter leaves in ``reduce.tree_leaves`` order:
    the padded embedding, then per layer ffn down/gate/up and mix k/o/q/v."""
    from repro_torch.models.params import padded_vocab

    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.d_head
    layer = [(f, d), (d, f), (d, f), (d, hd), (hd, d), (d, hd), (d, hd)]
    return [(padded_vocab(cfg.vocab_size), d)] + layer * cfg.n_layers


def check_parts_training(results: dict, gen) -> None:
    """K4 at the training path's size: the clip statistic over olmo-1b's
    113 f32 gradient leaves (1.18 B elements), with the optimizer's
    epilogue fork and the census. Also times the fused kernel (K1) over one
    buffer of the same elements, f32 compute and square prologue: the same
    bytes streamed with a 528-lane fold instead of K4's single-thread fold
    over every tile partial, so the difference estimates that fold."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mma_sum_fused, mma_sum_parts
    from repro_torch.kernels.mma_reduce import default_num_lanes, mma_sum_parts_plain

    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 1e-3
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    total = sum(p.numel() for p in leaves)
    tiles = sum(-(-p.numel() // 16384) for p in leaves)
    chains = ((("sqrt",),), (("sqrt",), ("clip_coeff", 1.0, 1e-9)))
    pros = ("square",) * len(leaves)

    def k4():
        return mma_sum_parts(leaves, prologue="square", total_chains=chains, census=True)

    out, again = k4(), k4()
    plain = mma_sum_parts_plain(leaves, pros, chains, True)
    torch.cuda.synchronize()
    s = len(leaves)
    mass = float(plain[:s].sum())
    err = float((out[:s + 2] - plain[:s + 2]).abs().max())
    print(f"K4 mma_sum_parts, training shape: {s} f32 leaves, {total} elements, {tiles} tiles: "
          f"max_abs_err {err:.3g} vs plain at mass {mass:.4g} (tol: 1e-6 x mass -- f32 sums "
          f"in another order); gnorm {float(out[s]):.6g}, clip {float(out[s + 1]):.6g}")
    check(torch.equal(out, again), "K4 (training shape): a second launch folds differently")
    check(torch.equal(out[s + 2:], plain[s + 2:]) and float(out[-1]) == 0.0,
          "K4 (training shape): census differs from plain")
    check(err <= 1e-6 * mass, "K4 (training shape) disagrees with its plain version")
    b_k4, by_k4 = bound_ms(total * 4 + out.numel() * 4, core_flops=2 * total)
    lib = getattr(torch.nn.utils, "get_total_norm", None)
    # Each of these calls keeps the card busy for milliseconds, far longer
    # than its host work (~0.1 ms), so CUDA events around back-to-back calls
    # read device time; the profiler is kept off the plain version, whose
    # ~144 000 small kernels per call make it drop events.
    results["mma_sum_parts"].update({
        "max_abs_err": err,
        "ms": time_ms(k4, iters=5, warmup=1),
        "profiler_ms": device_ms(k4, "parts_kernel", iters=5, warmup=0),
        "plain_ms": time_ms(lambda: mma_sum_parts_plain(leaves, pros, chains, True),
                            iters=1, warmup=0),
        "bound_ms": b_k4, "bound_by": by_k4,
        "library_ms": time_ms(lambda: lib(leaves), iters=5, warmup=1) if lib is not None else None,
        "tiles": tiles,
    })
    results["mma_sum_parts"]["call_ms"] = results["mma_sum_parts"]["ms"]
    flat = torch.cat([p.reshape(-1) for p in leaves])
    del leaves
    lanes = default_num_lanes(flat)
    stream_ms = time_ms(lambda: mma_sum_fused(flat, compute_dtype=torch.float32,
                                              prologue="square", num_lanes=lanes),
                        iters=5, warmup=1)
    fold = results["mma_sum_parts"]["ms"] - stream_ms
    results["mma_sum_parts"]["fold_estimate_ms"] = fold
    print(f"K4 at the training shape: {results['mma_sum_parts']['ms']:.4f} ms on the card "
          f"(CUDA events; the profiler reads {results['mma_sum_parts']['profiler_ms']:.4f} ms); "
          f"K1 over the same {total} f32 elements ({lanes} lanes): {stream_ms:.4f} ms; "
          f"the difference, {fold:.4f} ms, estimates K4's single-thread fold over "
          f"{tiles} tile partials")
    del flat
    torch.cuda.empty_cache()


def check_cross_entropy(results: dict, gen) -> None:
    """K7 against its plain version: the training path's (2048, 50432) f32
    padded logits (pad logits at -1e30, as the chunked loss's head gives
    them), the same logits cut to the 50304 real columns (the serving
    head's width: the same loss), a ragged odd width (the kernel's unpaired
    loads) and bf16 logits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy
    from repro_torch.kernels.cross_entropy import cross_entropy_plain

    rows, width, vocab = TRAIN_BATCH * TRAIN_SEQ, 50432, 50304
    cases = [(300, 1001, torch.float32), (256, vocab, torch.bfloat16),
             (rows, width, torch.float32)]  # the last: the training path (timed)
    for r, w, dtype in cases:
        logits = torch.randn((r, w), generator=gen, device=DEVICE) * 3
        logits[:, vocab:] = -1e30
        logits = logits.to(dtype)
        labels = torch.randint(0, min(w, vocab), (r,), generator=gen, device=DEVICE)
        out = cross_entropy(logits, labels)
        plain = cross_entropy_plain(logits, labels)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        print(f"K7 cross_entropy ({r}, {w}) {str(dtype)[6:]}: max_abs_err {err:.3g} vs plain "
              "(tol 1e-3: the same 512-column tiles and running max; expf and torch.exp may "
              "differ in the last ulp and flip one bf16 rounding of p, moving l by up to "
              "2^-9 of that p)")
        check(bool(torch.isfinite(out).all()), "cross_entropy non-finite")
        check(err <= 1e-3, f"cross_entropy disagrees with its plain version at {(r, w)}")
    cut = cross_entropy(logits[:, :vocab].contiguous(), labels)
    d_cut = float((cut - out).abs().max())
    print(f"K7 the same logits cut to their {vocab} real columns: max |d| {d_cut:.3g} "
          "(tol 1e-6: pad logits at -1e30 add exactly 0)")
    check(d_cut <= 1e-6, "cross_entropy: padded and cut widths differ")
    n = rows * width
    b_ce, by_ce = bound_ms(n * 4 + rows * 8, tensor_flops=16 * n, core_flops=4 * n)
    lab64 = labels.to(torch.int64)
    results["cross_entropy"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: cross_entropy(logits, labels), "::ce_kernel<"),
        "call_ms": time_ms(lambda: cross_entropy(logits, labels), iters=20),
        "plain_ms": device_ms(lambda: cross_entropy_plain(logits, labels), iters=3),
        "bound_ms": b_ce, "bound_by": by_ce,
        "library_ms": device_ms(lambda: F.cross_entropy(logits, lab64, reduction="none")),
    }


def fused_tol(n: int, lanes: int, mass: float) -> float:
    """One f32 ulp of the running sum per accumulation step, n / (lanes x
    256) steps per thread (tensor cores may truncate their f32
    accumulation), times the mass."""
    from repro_torch.kernels.mma_reduce import lane_geometry

    c = lane_geometry(n, lanes)[1]
    return max(1.0, n / (c * 256)) * 2.0**-23 * mass + 1e-6


def check_fused_sum(results: dict, gen) -> None:
    """K1 against its plain version: the training path's token sum ((4,
    512) f32 per-token losses at bf16 compute), 2^26 bf16 elements (where
    bytes matter), the census on planted NaN/Inf, an epilogue chain, and a
    bitwise repeat of every launch."""
    import torch

    from repro_torch.kernels import mma_sum_fused
    from repro_torch.kernels.mma_reduce import default_num_lanes, mma_sum_fused_plain

    def compare(x, what, **kw):
        lanes = kw.setdefault("num_lanes", default_num_lanes(x))
        got, again, want = mma_sum_fused(x, **kw), mma_sum_fused(x, **kw), mma_sum_fused_plain(x, **kw)
        got_t, want_t = (got[0], want[0]) if kw.get("census") else (got, want)
        torch.cuda.synchronize()
        xf = x.float().nan_to_num(0.0, 0.0, 0.0)
        mass = float((xf * xf if kw.get("prologue") == "square" else xf.abs()).sum())
        err = abs(float(got_t) - float(want_t))
        print(f"K1 mma_sum_fused {what}: {float(got_t):.9g} vs plain {float(want_t):.9g}, "
              f"max_abs_err {err:.3g} at mass {mass:.4g} (tol {fused_tol(x.numel(), lanes, mass):.3g}"
              ": one f32 ulp of the running sum per accumulation step); repeat bitwise")
        same = all(torch.equal(a, b) for a, b in zip(got, again)) if kw.get("census") else (
            torch.equal(got, again))
        check(same, f"K1 {what}: a second launch differs")
        check(err <= fused_tol(x.numel(), lanes, mass), f"K1 {what} disagrees with its plain version")
        return got, want

    path = torch.rand((TRAIN_BATCH, TRAIN_SEQ), generator=gen, device=DEVICE) * 4 + 9
    compare(path, f"({TRAIN_BATCH}, {TRAIN_SEQ}) f32 at bf16 compute (the token sum)")
    # A non-zero mean: a lost lane block (131072 elements) or a lost warp's
    # share then moves the sum by far more than the tolerance.
    big = (torch.randn((2**26,), generator=gen, device=DEVICE) * 2 + 0.3).to(torch.bfloat16)
    compare(big, "2^26 bf16 at bf16 compute")
    compare(big, "2^26 bf16, abs at bf16 compute", prologue="abs")
    compare(big, "2^26 bf16, square at f32 compute, epilogue sqrt+clip", prologue="square",
            compute_dtype=torch.float32, epilogue=(("sqrt",), ("clip_coeff", 1.0, 1e-9)))
    bad = torch.randn((5 * 131072 + 3,), generator=gen, device=DEVICE)
    bad[7], bad[131072], bad[-1] = float("nan"), float("inf"), float("-inf")
    (tot, cnt), (_, pcnt) = compare(bad.nan_to_num(0.0, 0.0, 0.0), "census, clean", census=True)
    check(float(cnt) == float(pcnt) == 0.0, "K1 census counts a clean input")
    (tot, cnt), (_, pcnt) = (mma_sum_fused(bad, census=True, num_lanes=4),
                             mma_sum_fused_plain(bad, census=True, num_lanes=4))
    print(f"K1 census with NaN/Inf planted: count {float(cnt)}, plain {float(pcnt)}, "
          f"total {float(tot)}")
    check(float(cnt) == float(pcnt) == 3.0 and not bool(torch.isfinite(tot)),
          "K1 census counts wrong")

    def timings(x):
        lanes = default_num_lanes(x)
        nbytes = x.numel() * x.element_size() + 8
        b, by = bound_ms(nbytes, tensor_flops=16 * x.numel(), core_flops=2 * x.numel())
        return {
            "ms": device_ms(lambda: mma_sum_fused(x, num_lanes=lanes), "fused_sum_kernel"),
            "call_ms": time_ms(lambda: mma_sum_fused(x, num_lanes=lanes)),
            "plain_ms": device_ms(lambda: mma_sum_fused_plain(x, num_lanes=lanes), iters=5),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.sum(x, dtype=torch.float32)),
        }

    results["mma_sum_fused"] = dict(
        timings(path),
        max_abs_err=abs(float(mma_sum_fused(path)) - float(mma_sum_fused_plain(path))),
        at_2e26_bf16=timings(big),
    )


# ------------------------- the paper's reduction (K10, K2, K3) -----------------------

_UNIT = {"torch.float32": 2.0**-24, "torch.bfloat16": 2.0**-8, "torch.float16": 2.0**-11}


def _unit(dtype) -> float:
    """Unit roundoff of a compute dtype."""
    return _UNIT[str(dtype)]


def _mapped(x, compute, prologue):
    """x cast to the compute dtype and mapped by the prologue there, as f32
    (the squares of "moments")."""
    from repro_torch.kernels.mma_reduce.ops import _map, _round

    return _map(_round(x.float(), compute), "square" if prologue == "moments" else prologue,
                compute)


def _tile_tol(v, compute):
    """Per tile of a K10 level over the mapped values ``v``: two ulps of the
    tile's largest row sum at the compute dtype (a row summed in another
    order may round the other way before the second MMA; f32 sums on the
    card and in torch take other orders) plus f32 noise of its mass."""
    import torch

    t = -(-v.numel() // 16384)
    rows = torch.nn.functional.pad(v, (0, t * 16384 - v.numel())).view(t, 128, 128)
    rows = rows.sum(-1).abs()
    return 4 * _unit(compute) * rows.amax(-1) + 2.0**-16 * rows.sum(-1) + 1e-6


def plain_hierarchy(x, compute, prologue="identity", chain=()):
    """The hierarchy with every level's plain version, on the card."""
    from repro_torch.kernels.mma_reduce import tile_partials_plain

    v, pro = x, prologue
    while v.numel() > 1:
        t = -(-v.numel() // 16384)
        v = tile_partials_plain(v, compute, pro, chain if t == 1 else ())[:t]
        pro = "identity"
    return (_mapped(v, compute, pro) if pro != "identity" else v).reshape(())


def hierarchy_tol(x, compute, prologue="identity") -> float:
    """The levels' tile tolerances (``_tile_tol``) summed along the plain
    hierarchy."""
    from repro_torch.kernels.mma_reduce import tile_partials_plain

    v, pro, tol = x, prologue, 0.0
    while v.numel() > 1:
        tol += float(_tile_tol(_mapped(v, compute, pro), compute).sum())
        v = tile_partials_plain(v, compute, pro)[:-(-v.numel() // 16384)]
        pro = "identity"
    return tol


def check_tile_partials(results: dict, gen) -> None:
    """K10 against its plain version on the card: level 0 tile by tile, then
    the whole hierarchy (two launches at 2^28) against the plain hierarchy
    and the f64 sum, with its launch count and the bytes at the launch
    boundary held against the cost model. The main path's f32 2^28, bf16
    2^28, 2^28 - 4097 (the tail mask), f16 once, the square, abs and
    moments prologues, and an epilogue chain on the final level."""
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels import common
    from repro_torch.kernels.mma_reduce import (mma_moments_hier, mma_sum_hier, tile_partials,
                                                tile_partials_plain)

    base = torch.randn((PAPER_N,), generator=gen, device=DEVICE) * 2 + 0.3
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # what, x, compute, prologue, chain
        ("2^28 f32 at bf16 compute (the demo's sum)", base, bf, "identity", ()),
        ("2^28 f32 at f32 compute", base, f32, "identity", ()),
        ("2^28 bf16", base.to(bf), bf, "identity", ()),
        ("2^28 - 4097 bf16 (tail mask)", base[:PAPER_N - 4097].to(bf), bf, "identity", ()),
        # zero mean: f16 partials of a 0.3 mean overflow at level 1 (rows of
        # 128 partials of ~4900), the reference's semantics too
        ("2^26 f16, mean 0", (base[:2**26] - 0.3).to(torch.float16), torch.float16, "identity",
         ()),
        ("2^28 bf16, square", base.to(bf), bf, "square", ()),
        ("2^28 bf16, abs", base.to(bf), bf, "abs", ()),
        ("2^28 f32, square at f32, chain sqrt+clip", base, f32, "square",
         (("sqrt",), ("clip_coeff", 1.0, 1e-9))),
    ]
    for what, x, cd, pro, chain in cases:
        n = x.numel()
        level0 = tile_partials(x, compute_dtype=cd, prologue=pro)
        want0 = tile_partials_plain(x, cd, pro)[:level0.numel()]
        err0 = float((level0 - want0).abs().max())
        check(bool(torch.all((level0 - want0).abs() <= _tile_tol(_mapped(x, cd, pro), cd))),
              f"K10 level 0 ({what}) disagrees with its plain version")
        before, tr = tile_partials.launches, []
        total = float(mma_sum_hier(x, compute_dtype=cd, prologue=pro, epilogue=chain, trace=tr))
        launched = tile_partials.launches - before
        raw, tol = float(plain_hierarchy(x, cd, pro)), hierarchy_tol(x, cd, pro)
        exact = float(_mapped(x, f32, pro).double().sum())
        mass = float(_mapped(x, f32, "abs" if pro == "identity" else pro).double().sum())
        tol_f64 = max(2 * _unit(cd), 2.0**-17) * mass + 1e-6
        want = raw
        if chain:  # the chain of the total: its relative errors carry over
            def fin(v):
                return float(common.apply_epilogue(torch.tensor(v, dtype=torch.float64), chain))

            want, exact_c = fin(raw), fin(exact)
            tol, tol_f64 = abs(want) * tol / abs(raw), abs(exact_c) * tol_f64 / abs(exact)
            exact = exact_c
        model = cost_model.hier_hbm_bytes(n, x.element_size())
        print(f"K10 tile_partials {what}: level 0 max_abs_err {err0:.3g} vs plain (tol: 2 ulps of "
              f"each tile's largest row sum at the compute dtype); hierarchy {total:.9g} vs plain "
              f"{want:.9g} (|d| {abs(total - want):.3g}, tol {tol:.3g}: the levels' tile "
              f"tolerances summed), vs f64 {exact:.9g} (|d| {abs(total - exact):.3g}, tol "
              f"{tol_f64:.3g}: two compute-dtype roundings of the mass); {launched} launches, "
              f"{tr[0].launch_io_bytes} bytes at the launches (cost model "
              f"{cost_model.levels(n, 128)}, {model.launch_io})")
        check(abs(total - want) <= tol, f"K10 hierarchy ({what}) disagrees with its plain version")
        check(abs(total - exact) <= tol_f64, f"K10 hierarchy ({what}) is off the f64 sum")
        check(launched == cost_model.levels(n, 128) == tr[0].levels,
              f"K10 ({what}): {launched} launches, cost model {cost_model.levels(n, 128)}")
        check(tr[0].launch_io_bytes == model.launch_io,
              f"K10 ({what}): {tr[0].launch_io_bytes} bytes at the launches, model {model.launch_io}")
    # the moments prologue: a (t, 2) level 0, then one hierarchy per column
    x = base.to(bf)
    pair = tile_partials(x, compute_dtype=bf, prologue="moments")
    want = tile_partials_plain(x, bf, "moments")[:pair.shape[0]]
    check(bool(torch.all((pair[:, 0] - want[:, 0]).abs() <= _tile_tol(_mapped(x, bf, "abs"), bf)))
          and bool(torch.all((pair[:, 1] - want[:, 1]).abs() <= _tile_tol(_mapped(x, bf, "square"),
                                                                          bf))),
          "K10 moments level 0 disagrees with its plain version")
    before, tr = tile_partials.launches, []
    s, ss = mma_moments_hier(x, trace=tr)
    t0 = -(-PAPER_N // 16384)
    check(tile_partials.launches - before == 1 + 2 * cost_model.levels(t0, 128),
          "K10 moments: launch count")
    check(tr[0].launch_io_bytes == cost_model.hier_moments_hbm_bytes(PAPER_N, 2).launch_io,
          "K10 moments: bytes at the launches differ from the cost model")
    ps, pss = float(plain_hierarchy(x, bf)), float(plain_hierarchy(x, bf, "square"))
    print(f"K10 moments 2^28 bf16: ({float(s):.9g}, {float(ss):.9g}) vs plain ({ps:.9g}, "
          f"{pss:.9g}); {tr[0].levels} launches, bytes as the cost model")
    check(abs(float(s) - ps) <= hierarchy_tol(x, bf)
          and abs(float(ss) - pss) <= hierarchy_tol(x, bf, "square"),
          "K10 moments hierarchy disagrees with its plain version")

    def timings(x):
        n = x.numel()
        b, by = bound_ms(n * x.element_size() + 4, tensor_flops=16 * n)
        return {
            "ms": device_ms(lambda: mma_sum_hier(x), "::tile_partials_kernel<"),
            "call_ms": time_ms(lambda: mma_sum_hier(x), iters=20),
            "plain_ms": device_ms(lambda: plain_hierarchy(x, bf), iters=3),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.sum(x, dtype=torch.float32)),
        }

    results["tile_partials"] = dict(
        timings(base), max_abs_err=abs(float(mma_sum_hier(base)) - float(plain_hierarchy(base, bf))),
        at_2e28_bf16=timings(base.to(bf)))


def check_moments_and_kahan(results: dict, gen) -> None:
    """K2 and K3 at 2^28 (the demo's f32, and bf16) against their plain
    versions and the f64 sums, repeat launches bitwise; then Kahan against
    native where the carry dominates: one lane, 2^24 f32."""
    import torch

    from repro_torch.core.precision import ulps
    from repro_torch.kernels.mma_reduce import (default_num_lanes, mma_moments_fused,
                                                mma_moments_fused_plain, mma_sum_fused,
                                                mma_sum_kahan, mma_sum_kahan_plain)

    base = torch.randn((PAPER_N,), generator=gen, device=DEVICE) * 2 + 0.3
    bf = torch.bfloat16
    for what, x in (("2^28 f32 at bf16 compute", base), ("2^28 bf16", base.to(bf)),
                    ("2^28 - 4097 bf16", base[:PAPER_N - 4097].to(bf))):
        lanes = default_num_lanes(x)
        (s, ss), (s2, ss2) = mma_moments_fused(x, num_lanes=lanes), mma_moments_fused(
            x, num_lanes=lanes)
        ps, pss = mma_moments_fused_plain(x, bf, lanes)
        xc = x.to(bf).double()
        ts = fused_tol(x.numel(), lanes, float(xc.abs().sum()))
        tss = fused_tol(x.numel(), lanes, float((x.float() ** 2).sum()))
        es, ess = float(xc.sum()), float((xc * xc).sum())
        print(f"K2 mma_moments_fused {what}: ({float(s):.9g}, {float(ss):.9g}) vs plain "
              f"|d| ({abs(float(s) - float(ps)):.3g}, {abs(float(ss) - float(pss)):.3g}) (tol "
              f"({ts:.3g}, {tss:.3g}): one f32 ulp of the running sum per accumulation step); "
              f"vs f64 of the bf16 values and their bf16 squares |d| ({abs(float(s) - es):.3g}, "
              f"{abs(float(ss) - ess):.3g}); repeat bitwise")
        check(torch.equal(s, s2) and torch.equal(ss, ss2), f"K2 {what}: a second launch differs")
        check(abs(float(s) - float(ps)) <= ts and abs(float(ss) - float(pss)) <= tss,
              f"K2 {what} disagrees with its plain version")
        check(abs(float(s) - es) <= ts + 1e-6 * float(xc.abs().sum())
              and abs(float(ss) - ess) <= tss + 2 * _unit(bf) * float((xc * xc).sum()),
              f"K2 {what} is off the f64 sums")
        k, k2 = mma_sum_kahan(x, num_lanes=lanes), mma_sum_kahan(x, num_lanes=lanes)
        kp = mma_sum_kahan_plain(x, bf, "identity", (), lanes)
        mass = float(xc.abs().sum())
        print(f"K3 mma_sum_kahan {what}: {float(k):.9g} vs plain {float(kp):.9g} (|d| "
              f"{abs(float(k) - float(kp)):.3g}, tol {2.0**-20 * mass:.3g}: the same row sums up "
              f"to their order, carried and folded by the same steps), vs f64 of the bf16 values "
              f"|d| {abs(float(k) - es):.3g}; repeat bitwise")
        check(torch.equal(k, k2), f"K3 {what}: a second launch differs")
        check(abs(float(k) - float(kp)) <= 2.0**-20 * mass, f"K3 {what} disagrees with plain")
        check(abs(float(k) - es) <= 2.0**-20 * mass + 1e-3, f"K3 {what} is off the f64 sum")

    # one lane, 1024 tiles: f32 compute, so only the carry differs
    for what, x, gate in (
            ("1 + U[0, 1e-3) (one-sided noise)", 1.0 + torch.rand(
                (2**24,), generator=gen, device=DEVICE) * 1e-3, True),
            ("1 + N(0, 1e-3) (symmetric noise)", 1.0 + torch.randn(
                (2**24,), generator=gen, device=DEVICE) * 1e-3, False)):
        exact = float(x.double().sum())
        native = float(mma_sum_fused(x, compute_dtype=torch.float32, num_lanes=1))
        kahan = float(mma_sum_kahan(x, compute_dtype=torch.float32, num_lanes=1))
        print(f"Kahan where the carry dominates, 2^24 f32 {what}, one lane, f32 compute: native "
              f"off the f64 sum by {abs(native - exact):.4g} ({ulps(native, exact):.1f} ulps of "
              f"the total), kahan by {abs(kahan - exact):.4g} ({ulps(kahan, exact):.1f} ulps)")
        if gate:
            check(ulps(native, exact) >= 10, "the carry-dominated input does not stress native")
            check(abs(kahan - exact) <= abs(native - exact), "Kahan is less accurate than native")

    def timings(x, fn, plain, kernel, library):
        n = x.numel()
        b, by = bound_ms(n * x.element_size() + 8, tensor_flops=16 * n)
        return {"ms": device_ms(fn, kernel), "call_ms": time_ms(fn, iters=20),
                "plain_ms": device_ms(plain, iters=3), "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(library) if library is not None else None}

    lanes = default_num_lanes(base)
    xb = base.to(bf)
    results["mma_moments_fused"] = dict(
        timings(base, lambda: mma_moments_fused(base, num_lanes=lanes),
                lambda: mma_moments_fused_plain(base, bf, lanes), "::fused_sum_kernel<", None),
        max_abs_err=abs(float(mma_moments_fused(base, num_lanes=lanes)[0])
                        - float(mma_moments_fused_plain(base, bf, lanes)[0])),
        at_2e28_bf16=timings(xb, lambda: mma_moments_fused(xb, num_lanes=lanes),
                             lambda: mma_moments_fused_plain(xb, bf, lanes),
                             "::fused_sum_kernel<", None))
    results["mma_sum_kahan"] = dict(
        timings(base, lambda: mma_sum_kahan(base, num_lanes=lanes),
                lambda: mma_sum_kahan_plain(base, bf, "identity", (), lanes),
                "::fused_kahan_kernel<", lambda: torch.sum(base, dtype=torch.float32)),
        max_abs_err=abs(float(mma_sum_kahan(base, num_lanes=lanes))
                        - float(mma_sum_kahan_plain(base, bf, "identity", (), lanes))),
        at_2e28_bf16=timings(xb, lambda: mma_sum_kahan(xb, num_lanes=lanes),
                             lambda: mma_sum_kahan_plain(xb, bf, "identity", (), lanes),
                             "::fused_kahan_kernel<", lambda: torch.sum(xb, dtype=torch.float32)))


def check_reduce_against_cpu(gen) -> None:
    """``reduce`` on the card against the same call on the CPU (the kernels'
    plain versions) at 2^20, every kind, backend and precision. Tolerance:
    the compute dtype's unit roundoff times the mass / 64 (a row sum may
    round the other way; lanes fold in other orders), f32 noise at f32
    compute."""
    import torch

    from repro_torch import reduce as R

    x = torch.randn((2**20,), generator=gen, device=DEVICE) * 2 + 0.3
    xc = x.cpu()
    worst = 0.0
    for backend in R.available_backends():
        for kind in ("sum", "mean", "sumsq", "norm2", "moments"):
            for prec in ("native", "kahan"):
                # "segmented" picks its executor by device: at native
                # precision, hold the card's pick against the same
                # executor's plain versions on the CPU; under "kahan" it
                # runs the blocked combine over torch-math block sums on
                # either device, so against itself
                cpu_backend = (R.segmented_backend_for(x.numel(), x.dtype, 128, x.device)
                               if backend == "segmented" and prec == "native" else backend)
                got = R.reduce(x, kind=kind, backend=backend, precision=prec)
                want = R.reduce(xc, kind=kind, backend=cpu_backend, precision=prec)
                cd = R.plan_for(x.shape, x.dtype, kind=kind, backend=backend).compute_torch
                pairs = zip(got, want, ("sum", "sumsq")) if kind == "moments" else [
                    (got, want, kind)]
                for g, w, k in pairs:
                    v = xc.double() ** 2 if k in ("sumsq", "norm2") else xc.double().abs()
                    tol = max(_unit(cd) / 64, 2.0**-20) * float(v.sum())
                    if k == "mean":
                        tol /= x.numel()
                    if k == "norm2":
                        tol /= 2 * float(w)
                    err = abs(float(g) - float(w))
                    worst = max(worst, err / tol)
                    check(g.device.type == "cuda" and err <= tol,
                          f"reduce({kind}, {backend}, {prec}): card {float(g)} vs CPU {float(w)}")
    print(f"reduce card vs CPU, 2^20 f32, {len(R.available_backends())} backends x 5 kinds x "
          f"2 precisions: all within tolerance (worst |d| / tol {worst:.3g})")


def check_auto_route(gen) -> None:
    """``reduce(x)`` with no backend named, at 2^28 f32 on the card: the
    planner takes the operand's device and sends a full reduction this long
    to ``cuda_fused``, ONE launch of K1 and no other kernel. Tolerance: one
    bf16 unit roundoff (the auto plan's compute dtype) times the mass,
    against the f64 sum. An f64 operand of 2 m^2 elements, which the
    kernels cannot read, stays on ``mma_torch`` and launches none (within
    n f64 unit roundoffs times the mass)."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.kernels import common

    x = torch.randn((PAPER_N,), generator=gen, device=DEVICE) + 0.5
    plan = R.plan_for(x.shape, x.dtype, device=x.device)
    torch.cuda.synchronize()
    common.reset_launches()
    got = R.reduce(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in common.launch_counts().items() if v}
    exact = float(x.double().sum())
    err = abs(float(got) - exact)
    print(f"reduce(x) on auto, 2^28 f32 on the card: plan backend {plan.backend}, launches "
          f"{launches}, |d| vs f64 {err:.4g} (sum {exact:.6g})")
    check(plan.backend == "cuda_fused" and launches == {"mma_sum_fused": 1},
          f"auto reduce at 2^28 on the card did not take one cuda_fused launch: {launches}")
    check(err <= 2.0**-8 * float(x.double().abs().sum()), "auto reduce at 2^28: off the f64 sum")
    x64 = x[:2 * 128 * 128].double()
    plan64 = R.plan_for(x64.shape, x64.dtype, device=x64.device)
    torch.cuda.synchronize()
    common.reset_launches()
    got64 = R.reduce(x64)
    torch.cuda.synchronize()
    launches64 = {k: v for k, v in common.launch_counts().items() if v}
    err64 = abs(float(got64) - float(x64.sum()))
    print(f"reduce(x) on auto, 2*128^2 f64 on the card: plan backend {plan64.backend}, "
          f"launches {launches64}, |d| vs torch.sum {err64:.4g}")
    check(plan64.backend == "mma_torch" and not launches64 and got64.dtype == torch.float64,
          f"auto reduce of f64 on the card: {plan64.backend}, {launches64}")
    check(err64 <= x64.numel() * 2.0**-53 * float(x64.abs().sum()),
          "auto reduce of f64 on the card: off torch.sum")


# -------------------- the multi-reduce and scan path (K8, K9, K4) --------------------

MULTI_N = 2**28  # the packed buffer and the scans: 1.07 GB of f32
SEGMENTS = 2048


def _segment_mass(x, offsets, square=False):
    """(S,) f64 sums of |x| (or x^2) per segment, on the card."""
    import torch
    import numpy as np

    lengths = torch.from_numpy(np.diff(offsets)).to(x.device)
    ids = torch.repeat_interleave(torch.arange(lengths.numel(), device=x.device), lengths)
    v = x.double()
    v = v * v if square else v.abs()
    return torch.zeros(lengths.numel(), dtype=torch.float64, device=x.device).index_add_(
        0, ids, v.nan_to_num(0.0, 0.0, 0.0))


def check_segments(results: dict, gen) -> None:
    """K8 at 2^28 in 2048 packed ragged segments (the demo's offsets: two
    empty in the middle, boundaries off the tile grid) against its plain
    version: f32 and bf16 input, the default lanes and 1 lane, the square
    prologue at f32 compute (bitwise: the same adds in the same order),
    moments, the census on planted NaN/Inf, an epilogue chain; one launch
    per call, and the launch-boundary bytes against
    ``cost_model.segmented_hbm_bytes``. Tolerance at bf16 compute: 2^-16 of
    each segment's mass -- the same element roundings, summed in f32 in
    another order on the tensor cores (a lost row or tile would move a
    segment by 2^-10 of its mass or more); counts exact."""
    import numpy as np
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels.mma_reduce import default_num_lanes, ops
    from repro_torch.launch.reduce_demo import packed_offsets

    offsets = packed_offsets(MULTI_N, SEGMENTS, 0)
    nseg = SEGMENTS
    cover_src = ops.segment_cover_layout(offsets, ops.TILE)[1]
    fetched = ops._cover_fetched_elems(cover_src, MULTI_N, ops.TILE)
    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) * 2 + 0.3
    lanes = default_num_lanes(x)
    bf, f32 = torch.bfloat16, torch.float32
    mass = _segment_mass(x, offsets)
    mass_sq = _segment_mass(x, offsets, square=True)

    def compare(what, xin, cd, lanes, prologue="identity", census=False, chain=(),
                bitwise=False):
        before, tr = ops.mma_sum_segments.launches, []
        got = ops.mma_sum_segments(xin, offsets, compute_dtype=cd, prologue=prologue,
                                   census=census, epilogue=chain, num_lanes=lanes, trace=tr)
        launched = ops.mma_sum_segments.launches - before
        want = ops.mma_sum_segments_plain(xin, offsets, cd, prologue, chain, census, lanes)
        torch.cuda.synchronize()
        sq = prologue in ("square", "moments")
        tol = 2.0**-16 * (mass_sq if sq else mass) + 1e-6
        if chain:  # (sqrt, clip): d clip / d t <= 1 / t near the clip point; d sqrt = dt / 2 sqrt t
            tol = tol / (2 * torch.sqrt(mass_sq.clamp_min(1.0)))
        g, w = got[:nseg].double(), want[:nseg].double()
        err = float((g - w).abs().nan_to_num(0.0).max())
        ok = bool(torch.all(((g - w).abs() <= tol) | (g == w) | (g.isnan() & w.isnan())))
        if prologue == "moments":
            ok &= bool(torch.all((got[nseg:].double() - want[nseg:].double()).abs()
                                 <= 2.0**-16 * mass_sq + 1e-6))
        if census:
            ok &= torch.equal(got[nseg:], want[nseg:])
        same = torch.equal(got.nan_to_num(), want.nan_to_num())
        model = cost_model.segmented_hbm_bytes(fetched, xin.element_size(), segments=got.numel(),
                                               tiles=cover_src.size, num_cores=lanes)
        print(f"K8 mma_sum_segments {what}, {tr[0].num_cores} lanes: max_abs_err {err:.3g} vs "
              f"plain (tol 2^-16 x segment mass{'; counts exact' if census else ''}), bitwise "
              f"{same}; {launched} launch, {tr[0].launch_io_bytes} bytes at the launch "
              f"(cost model {model.launch_io}; {fetched - xin.numel()} elements read twice at "
              "unaligned boundaries)")
        check(ok, f"K8 {what} ({lanes} lanes) disagrees with its plain version")
        check(not bitwise or same, f"K8 {what}: f32 compute is not bitwise its plain version")
        check(launched == 1, f"K8 {what}: {launched} launches")
        check(tr[0].launch_io_bytes == model.launch_io,
              f"K8 {what}: launch bytes {tr[0].launch_io_bytes} != model {model.launch_io}")
        return got, want

    for lanes_ in (lanes, 1):
        compare("2^28 f32 at bf16 compute", x, bf, lanes_)
    compare("2^28 f32, square at f32 compute", x, f32, lanes, "square", bitwise=True)
    compare("2^28 f32, moments at bf16 compute", x, bf, lanes, "moments")
    got, _ = compare("2^28 f32, square at f32, chain sqrt+clip", x, f32, lanes, "square",
                     chain=(("sqrt",), ("clip_coeff", 100.0, 1e-9)))
    check(bool(torch.all(got[[0, nseg // 3, 2 * nseg // 3]] == 1.0)),
          "K8: an empty segment's slot is not the chain of 0")
    xb = x.to(bf)
    compare("2^28 bf16", xb, bf, lanes)
    bad = x.clone()
    bad[[5, int(offsets[nseg // 2]), MULTI_N - 1]] = torch.tensor([float("nan"), float("inf"),
                                                             float("-inf")], device=DEVICE)
    got, _ = compare("2^28 f32, census on planted NaN/Inf", bad, bf, lanes, census=True)
    check(float(got[nseg:].sum()) == 3.0, "K8 census total is not 3")
    del bad

    lengths = torch.from_numpy(np.diff(offsets)).to(DEVICE)

    def timings(xin):
        n, isz = xin.numel(), xin.element_size()
        b, by = bound_ms(n * isz + nseg * 4, tensor_flops=16 * n)
        return {
            "ms": device_ms(lambda: ops.mma_sum_segments(xin, offsets, num_lanes=lanes),
                            "::segments_kernel<", iters=10),
            "call_ms": time_ms(lambda: ops.mma_sum_segments(xin, offsets, num_lanes=lanes),
                               iters=10),
            "plain_ms": time_ms(lambda: ops.mma_sum_segments_plain(
                xin, offsets, bf, "identity", (), False, lanes), iters=1, warmup=1),
            "bound_ms": b, "bound_by": by,
            "bound_fetched_ms": fetched * isz / HBM_BYTES_PER_S * 1e3,
            "library_ms": device_ms(lambda: torch.segment_reduce(xin, "sum", lengths=lengths),
                                    iters=10),
        }

    results["mma_sum_segments"] = dict(
        timings(x), at_2e28_bf16=timings(xb),
        max_abs_err=float((ops.mma_sum_segments(x, offsets, num_lanes=lanes)
                           - ops.mma_sum_segments_plain(x, offsets, bf, "identity", (), False,
                                                        lanes)).abs().max()))
    print(f"K8 timings at 2^28 f32 / bf16 ({lanes} lanes): device "
          f"{results['mma_sum_segments']['ms']:.4f} / "
          f"{results['mma_sum_segments']['at_2e28_bf16']['ms']:.4f} ms")


# K9's time per call at 2^28 f32 / bf16 before the look-back kernel: the
# one-SM kernel it replaced, by CUDA events on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md's table of kernels); printed beside this run's time, not
# measured here.
K9_ONE_SM_MS = {"float32": 201.631, "bfloat16": 178.206}


def check_scan(results: dict, gen) -> None:
    """K9 at 2^28 f32 (f32 compute: bitwise its plain version, the same
    adds in the same order) and bf16 (bf16 compute on the tensor cores:
    within one bf16 ulp of the output plus 2^-17 of the running mass --
    f32 sums of the same products in another order, then the same rounding
    to bf16); bitwise at 1, 2, 4 and 8 lanes, across five launches, and
    the exclusive scan the inclusive one shifted, at 2^24; one launch,
    launch-boundary bytes (input, output and look-back state) against the
    kernel's model ``cost_model.lookback_scan_hbm_bytes`` (the reference's
    striped ``scan_hbm_bytes`` printed beside it)."""
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels.scan import ops as sops

    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) + 0.1
    for what, xin in (("2^28 f32", x), ("2^28 bf16", x.to(torch.bfloat16))):
        before, tr = sops.mma_scan.launches, []
        got = sops.mma_scan(xin, trace=tr)
        launched = sops.mma_scan.launches - before
        want = sops.mma_scan_plain(xin)[:MULTI_N]
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        model = cost_model.lookback_scan_hbm_bytes(MULTI_N, xin.element_size())
        striped = cost_model.scan_hbm_bytes(MULTI_N, xin.element_size())
        if xin.dtype == torch.float32:
            ok = torch.equal(got, want)
            tol_text = "bitwise"
        else:
            run = torch.cumsum(xin.double().abs(), 0)
            ok = bool(torch.all((got.double() - want.double()).abs()
                                <= 2.0**-8 * want.double().abs() + 2.0**-17 * run + 1e-6))
            tol_text = "1 bf16 ulp + 2^-17 x running mass"
            del run
        rel = float(((got.double() - torch.cumsum(xin.double(), 0)).abs()).max())
        print(f"K9 mma_scan {what}: max_abs_err {err:.3g} vs plain (tol {tol_text}); max |d| "
              f"vs f64 cumsum {rel:.4g} at a final value {float(want[-1]):.6g}; {launched} "
              f"launch, {tr[0].launch_io_bytes} bytes at the launch (the kernel's model "
              f"{model.launch_io}; the reference's striped model {striped.launch_io} + "
              f"{striped.refetch_read} refetched at one lane)")
        check(ok, f"K9 {what} disagrees with its plain version")
        check(launched == 1, f"K9 {what}: {launched} launches")
        check(tr[0].launch_io_bytes == model.launch_io, f"K9 {what}: launch bytes off the model")
        del got, want
    small = x[:2**24]
    for xin in (small, small.to(torch.bfloat16)):
        outs = [sops.mma_scan(xin, num_lanes=c, tiles_per_block=1) for c in (1, 2, 4, 8)]
        outs += [sops.mma_scan(xin) for _ in range(5)]
        exc = sops.mma_scan(xin, inclusive=False)
        torch.cuda.synchronize()
        same = [torch.equal(o, outs[0]) for o in outs]
        shift = torch.equal(exc[1:], outs[0][:-1]) and float(exc[0]) == 0.0
        print(f"K9 2^24 {str(xin.dtype)[6:]}: bitwise at 1/2/4/8 lanes and across five more "
              f"launches {same}; exclusive is the inclusive shifted {shift}")
        check(all(same), "K9 output differs between lane counts or launches")
        check(shift, "K9 exclusive scan is not the inclusive one shifted")
        del outs, exc

    def timings(xin):
        n, isz = xin.numel(), xin.element_size()
        b, by = bound_ms(2 * n * isz, tensor_flops=3 * 2 * 128 * n)
        return {
            "ms": device_ms(lambda: sops.mma_scan(xin), "::scan_kernel<", iters=10),
            "call_ms": time_ms(lambda: sops.mma_scan(xin), iters=20),
            "plain_ms": time_ms(lambda: sops.mma_scan_plain(xin), iters=1, warmup=0),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.cumsum(xin, 0)),
        }

    results["mma_scan"] = dict(timings(x), at_2e28_bf16=timings(x.to(torch.bfloat16)),
                               max_abs_err=0.0)
    for what, r, dt in (("f32", results["mma_scan"], "float32"),
                        ("bf16", results["mma_scan"]["at_2e28_bf16"], "bfloat16")):
        print(f"K9 at 2^28 {what}: device {r['ms']:.4f} ms (profiler), call {r['call_ms']:.4f} "
              f"ms (CUDA events) (bound {r['bound_ms']:.4f}, torch.cumsum {r['library_ms']:.4f}; "
              f"the one-SM kernel it replaced: {K9_ONE_SM_MS[dt]} ms, from PERF.md, not this run)")


def check_parts_bf16(results: dict, gen) -> None:
    """K4 completed, over full-width olmo-1b's 113 parameter leaves (f32,
    1.18 B elements): ``mma_sum_parts`` at bf16 compute (kind sum) and
    with moments parts, against its plain version. Tolerance 2^-16 of each
    leaf's mass: the same element roundings, summed in f32 in another order
    on the tensor cores."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.mma_reduce import ops

    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 0.02
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    s = len(leaves)
    total = sum(p.numel() for p in leaves)
    absmass = torch.stack([p.double().abs().sum() for p in leaves])
    sqmass = torch.stack([(p.double() ** 2).sum() for p in leaves])
    figures = {}
    for pro in ("identity", "moments"):
        got = ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)
        again = ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)
        want = ops.mma_sum_parts_plain(leaves, (pro,) * s, (), False, torch.bfloat16)
        torch.cuda.synchronize()
        ok = bool(torch.all((got[:s].double() - want[:s].double()).abs()
                            <= 2.0**-16 * absmass + 1e-6))
        if pro == "moments":
            ok &= bool(torch.all((got[s:].double() - want[s:].double()).abs()
                                 <= 2.0**-16 * sqmass + 1e-6))
        err = float((got - want).abs().max())
        print(f"K4 mma_sum_parts at bf16 compute, {pro}, {s} f32 leaves ({total} elements): "
              f"max_abs_err {err:.3g} vs plain (tol 2^-16 x leaf mass); repeat bitwise "
              f"{torch.equal(got, again)}")
        check(ok, f"K4 at bf16 compute ({pro}) disagrees with its plain version")
        check(torch.equal(got, again), f"K4 at bf16 compute ({pro}): a second launch differs")
        nbytes = total * 4 + got.numel() * 4
        b, by = bound_ms(nbytes, tensor_flops=(32 if pro == "moments" else 16) * total)

        def k4(pro=pro):
            return ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)

        figures[pro] = {"max_abs_err": err, "ms": time_ms(k4, iters=3, warmup=1),
                        "plain_ms": time_ms(lambda pro=pro: ops.mma_sum_parts_plain(
                            leaves, (pro,) * s, (), False, torch.bfloat16), iters=1, warmup=0),
                        "bound_ms": b, "bound_by": by, "library_ms": None}
        print(f"K4 at bf16 compute, {pro}: {figures[pro]['ms']:.4f} ms per call (CUDA events), "
              f"bound {b:.4f} ms by {by}")
    results["mma_sum_parts"]["bf16_compute"] = figures
    del leaves
    torch.cuda.empty_cache()


def check_multi_against_cpu(gen) -> None:
    """``reduce_many`` (both axes, every backend and kind), ``scan`` (every
    backend) and ``reduce_tree``'s gradient (the kernel backends) on the
    card against the same calls on the CPU (the kernels' plain versions;
    "segmented" against the executor it picks on the card) at 2^20.
    Tolerance as the ``reduce`` check: the compute dtype's unit roundoff
    / 64 of the mass (f32 noise at f32 compute); per element of a scan,
    2^-18 of the running mass."""
    import torch

    from repro_torch import reduce as R

    sizes = (300, 0, 20000, 2**20 - 20300)
    x = torch.randn((2**20,), generator=gen, device=DEVICE) * 2 + 0.3
    parts = list(torch.split(x, sizes))
    cparts = [p.cpu() for p in parts]
    worst = 0.0
    for backend in R.available_backends():
        cpu_backend = (R.segmented_backend_for(x.numel(), x.dtype, 128, x.device)
                       if backend == "segmented" else backend)
        for kind in ("sum", "mean", "sumsq", "norm2", "moments"):
            cd = R.plan_for((x.numel(),), x.dtype, kind=kind, backend=cpu_backend,
                            segments=len(parts)).compute_torch
            unit = max(_unit(cd) / 64, 2.0**-20)
            got = R.reduce_many(parts, kind=kind, backend=backend)
            want = R.reduce_many(cparts, kind=kind, backend=cpu_backend)
            pairs = zip(got, want, ("sum", "sumsq")) if kind == "moments" else [(got, want, kind)]
            for g, w, k in pairs:
                for i, p in enumerate(cparts):
                    v = p.double() ** 2 if k in ("sumsq", "norm2") else p.double().abs()
                    tol = unit * float(v.sum()) + 1e-6
                    tol = tol / max(p.numel(), 1) if k == "mean" else tol
                    tol = tol / (2 * max(float(w[i]), 1e-3)) if k == "norm2" else tol
                    err = abs(float(g[i]) - float(w[i]))
                    worst = max(worst, err / tol)
                    check(g.device.type == "cuda" and err <= tol,
                          f"reduce_many({kind}, {backend}) slot {i}: card {float(g[i])} vs CPU "
                          f"{float(w[i])}")
            rows = [x[:3 * 1000].view(3, 1000), x[:0].view(0, 7), x[5000:5000 + 4 * 700].view(4, 700)]
            got = R.reduce_many(rows, kind=kind, axis=-1, backend=backend)
            want = R.reduce_many([r.cpu() for r in rows], kind=kind, axis=-1, backend=cpu_backend)
            flat_g = got[0] + got[1] if kind == "moments" else got
            flat_w = want[0] + want[1] if kind == "moments" else want
            for g, w in zip(flat_g, flat_w):
                check(tuple(g.shape) == tuple(w.shape) and bool(torch.allclose(
                    g.cpu(), w, rtol=unit * 64, atol=unit * 64 * 100)),
                    f"reduce_many({kind}, axis=-1, {backend}): card and CPU differ")
        # scans of every backend against themselves on the CPU ("segmented"
        # has no scan of its own: the base cumsum on either device); f32
        # compute, so f32 order noise of the running mass (cumsum is a
        # parallel scan on the card, double-accumulated on the CPU)
        y = x[:2**20 - 7]
        got = R.scan(y, backend=backend).cpu().double()
        want = R.scan(y.cpu(), backend=backend).double()
        run = torch.cumsum(y.cpu().double().abs(), 0)
        check(bool(torch.all((got - want).abs() <= 2.0**-18 * run + 1e-5)),
              f"scan({backend}): card and CPU differ")
    print(f"reduce_many card vs CPU, 2^20 f32 in 4 arrays (one empty), "
          f"{len(R.available_backends())} backends x 5 kinds, both axes, and scan: within "
          f"tolerance (worst |d| / tol of the full reductions {worst:.3g})")
    for backend in ("cuda_fused", "cuda_hier"):
        grads = []
        for ps in (parts, cparts):
            leaves = [p.detach().clone().requires_grad_(True) for p in ps]
            out = R.reduce_tree(leaves, "norm2", backend=backend,
                                epilogue=[(), ("clip_coeff", 1.0)])
            grads.append(torch.autograd.grad((out * torch.tensor([1.0, 3.0], device=out.device))
                                             .sum(), leaves, allow_unused=True))
        for g, c in zip(*grads):
            check((g is None) == (c is None) and (g is None or bool(torch.allclose(
                g.cpu(), c, rtol=1e-4, atol=1e-9))), f"reduce_tree gradient ({backend}) differs")
    print("reduce_tree(norm2, clip fork) gradients card vs CPU on cuda_fused and cuda_hier: "
          "within 1e-4 relative")


def check_packing_offsets(gen) -> None:
    """``packing_offsets`` of 2048 lengths (total below 2^24, so f32 is
    integer-exact) on ``cuda_fused`` (the scan kernel on the f32 copy of
    the lengths): exactly the host's int64 cumsum."""
    import numpy as np
    import torch

    from repro_torch.data import packing_offsets

    lengths = torch.randint(0, 8000, (SEGMENTS,), generator=gen, device=DEVICE).to(torch.int32)
    lengths[[3, SEGMENTS // 2]] = 0
    got = packing_offsets(lengths, backend="cuda_fused")
    want = np.concatenate([[0], np.cumsum(lengths.cpu().numpy().astype(np.int64))])
    print(f"packing_offsets of {SEGMENTS} lengths on cuda_fused: total {int(want[-1])} "
          f"(< 2^24), equal to the int64 cumsum {bool(np.array_equal(got.cpu().numpy(), want))}")
    check(int(want[-1]) < 2**24 and got.dtype == torch.int32
          and got.device.type == torch.device(DEVICE).type
          and np.array_equal(got.cpu().numpy(), want), "packing_offsets differs from cumsum")


def run_multi_reduce_path() -> dict:
    """The slice's main path, every kernel launch counted: ``reduce_many``
    over 2^28 f32 values in 2048 packed segments (more than 128 arrays:
    the pack and ONE launch of K8), ``reduce_many`` kinds sum and moments
    over olmo-1b's 113 parameter leaves (one K4 launch each, bf16
    compute), ``repro_torch.scan`` over 2^28 f32 and bf16 values (the auto
    route on the card: one K9 launch each) and ``packing_offsets`` on
    ``cuda_fused`` (one K9 launch). Returns the launch counts."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.data import packing_offsets
    from repro_torch.kernels import common
    from repro_torch.launch.reduce_demo import packed_offsets

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) + 1.0
    offsets = packed_offsets(MULTI_N, SEGMENTS, 1)
    docs = list(torch.split(x, np.diff(offsets).tolist()))
    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 0.02
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    lengths = torch.randint(0, 8000, (SEGMENTS,), generator=gen, device=DEVICE).to(torch.int32)
    xb = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    per_doc = R.reduce_many(docs, backend="cuda_fused")
    leaf_sums = R.reduce_many(leaves, kind="sum", backend="cuda_fused")
    leaf_s, leaf_ss = R.reduce_many(leaves, kind="moments", backend="cuda_fused")
    prefix = repro_torch.scan(x)
    prefix_b = repro_torch.scan(xb)
    offs = packing_offsets(lengths, backend="cuda_fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    print(f"multi-reduce and scan path: {wall:.2f} s; launches {launches}")
    check(per_doc.shape == (SEGMENTS,) and bool(torch.isfinite(per_doc).all()),
          "reduce_many over the packed documents: bad result")
    lens = torch.from_numpy(np.diff(offsets)).to(x.device)
    exact = torch.zeros(SEGMENTS, dtype=torch.float64, device=x.device).index_add_(
        0, torch.repeat_interleave(torch.arange(SEGMENTS, device=x.device), lens), x.double())
    check(bool(torch.all((per_doc.double() - exact).abs()
                         <= 2.0**-8 * _segment_mass(x, offsets) + 1e-3)),
          "reduce_many over the packed documents is off the f64 sums by more than bf16 rounding")
    check(bool(torch.isfinite(leaf_sums).all() and torch.isfinite(leaf_ss).all()
               and torch.all(leaf_ss >= 0)), "reduce_many over the olmo leaves: bad result")
    check(prefix.shape == x.shape and prefix_b.dtype == torch.bfloat16
          and abs(float(prefix[-1]) - float(x.double().sum())) <= 1e-3 * float(x.double().sum()),
          "scan of 2^28: bad result")
    check(int(offs[-1]) == int(lengths.long().sum()), "packing offsets: bad total")
    check(launches["mma_sum_segments"] == 1 and launches["mma_sum_parts"] == 2
          and launches["mma_scan"] == 3,
          f"the multi-reduce path ran {launches} launches, expected K8 1, K4 2, K9 3")
    return launches


def run_reduce_demo() -> dict:
    """The paper's main path: ``launch.reduce_demo``'s ``main`` at n = 2^28
    on the card, every kernel launch counted. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.launch import reduce_demo

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    out = reduce_demo.main(["--n", str(PAPER_N)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    print(f"reduce demo at n = {PAPER_N}: {wall:.2f} s; launches {launches}")
    for n, m, levels, steps, eq16, _, s_meas, s17 in out["steps"]:
        check(steps == 5 * levels and abs(eq16 - steps) < 1e-9 and abs(s_meas - s17) < 1e-9,
              f"step counts at n={n}, m={m} differ from eqs. 16-17")
    rel = {name: r for name, _, r in out["precision"]}
    check(all(np.isfinite(v) for v in rel.values()), "non-finite precision row")
    check(rel["cuda_fused f32 multipliers, kahan"] <= 1e-6, "Kahan's error is above 1e-6")
    check(all(ms > 0 for _, ms in out["times"]), "a time per call is not positive")
    seg = out["segments"]
    check(seg["count"] == 2048 and seg["worst_rel_to_mass"] <= 2.0**-8 and seg["ms"] > 0,
          "the demo's segmented section: bad result")
    for n, got, exact in seg["three"]:
        check(abs(got - exact) <= 1e-4 * exact, "the demo's three segments are off f64")
    for name in PAPER_KERNELS + ("mma_sum_segments",):
        check(launches[name] > 0, f"the paper's path did not launch {name}")
    return launches


def check_backward_times(results: dict, gen) -> None:
    """Device time of the torch-math backward passes of K5 (layernorm_np,
    the reference's host math) and K6 (dense recompute) at the training
    shapes; no kernel of this repository runs in them."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.row_moments.ops import layernorm_np_bwd

    x = torch.randn((TRAIN_BATCH * TRAIN_SEQ, 2048), generator=gen, device=DEVICE).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    q, k, v = ((torch.randn((TRAIN_BATCH, 16, TRAIN_SEQ, 128), generator=gen, device=DEVICE)
                * 0.5).to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    go = torch.randn(q.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    results["backward"] = {
        "layernorm_np_bwd_ms": device_ms(lambda: layernorm_np_bwd(x, g, 1e-5)),
        "attention_bwd_ms": device_ms(lambda: torch.autograd.grad(
            attention_ref(q, k, v, causal=True), (q, k, v), go), iters=5),
    }
    print(f"backward passes (torch math): layernorm_np ({x.shape[0]}, 2048) bf16 "
          f"{results['backward']['layernorm_np_bwd_ms']:.4f} ms; attention "
          f"{tuple(q.shape)} bf16, dense recompute {results['backward']['attention_bwd_ms']:.4f} ms")


# ------------------- the fused matmul with its row moments (K11) -------------------

# olmo-1b's MLP down projection: X is the training batch's (4 x 512, d_ff)
# hidden activations, W the (d_ff, d_model) projection, so Y's rows have the
# width of the LayerNorm that follows. The training rows at bf16 (timed:
# the kernel's main figures), the serving prefill's rows, and f32 operands
# (the in-kernel cast).
MS_CASES = ((TRAIN_BATCH * TRAIN_SEQ, "bfloat16"), (SLOTS * PROMPT, "bfloat16"),
            (TRAIN_BATCH * TRAIN_SEQ, "float32"))
MS_TOL = 1e-5  # s, ss: this fraction of each row's sum of |y|, of y^2


def ms_operands(m: int, dtype: str, gen):
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch("olmo-1b")
    x = torch.randn((m, cfg.d_ff), generator=gen, device=DEVICE).to(getattr(torch, dtype))
    w = (torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device=DEVICE) * 0.02).to(
        getattr(torch, dtype))
    return x, w


def ms_compare(x, w, got, want):
    """(max |dY|, worst |ds| / sum|y|, worst |dss| / sum y^2, ok): Y within
    one ulp of its dtype plus two f32 ulps of the product's absolute mass
    per accumulation step of 16 (the tensor cores' f32 accumulation may
    truncate; the other side sums in another order); s and ss within
    ``MS_TOL`` of each row's sum of |y| and of y^2 (both sides sum the f32
    accumulator, not the stored Y)."""
    import torch

    from repro_torch.kernels.common import bf16_round

    (y, s, ss), (yp, sp, ssp) = got, want
    xb, wb = bf16_round(x.float()), bf16_round(w.float())
    mass = xb.abs() @ wb.abs()
    ulp = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}[y.dtype]
    dy = (y.float() - yp.float()).abs()
    ok_y = bool(torch.all(dy <= ulp * yp.float().abs()
                          + 2.0**-22 * -(-x.shape[1] // 16) * mass + 1e-6))
    y32 = xb @ wb
    abs_mass, sq_mass = y32.abs().sum(-1), (y32 * y32).sum(-1)
    rs = float(((s - sp).abs() / (abs_mass + 1e-30)).max())
    rss = float(((ss - ssp).abs() / (sq_mass + 1e-30)).max())
    ok = ok_y and rs <= MS_TOL and rss <= MS_TOL
    return float(dy.max()), rs, rss, ok


def _ms_f64(x, w):
    """The f64 product of the bf16-rounded operands and its row moments."""
    from repro_torch.kernels.common import bf16_round

    y64 = bf16_round(x.float()).double() @ bf16_round(w.float()).double()
    return y64, y64.sum(-1), (y64 * y64).sum(-1)


def check_matmul_stats(results: dict, gen) -> None:
    """K11 against its plain version at the three full-width cases: Y, s and
    ss within ``ms_compare``'s tolerance, two launches bitwise the same, one
    launch per call; each side's moments against the f64 product, and the
    moments of the stored, rounded Y against ``MS_TOL`` (at bf16 they must
    fail it: the tolerance can tell the accumulator's moments from the
    output's). Card against CPU on a ragged case and on a K that is not
    16-byte aligned. Timed at each case; the library time is
    ``torch.matmul`` on the same bf16 operands, the product alone, with
    the product plus the two row reductions of its result beside it."""
    import torch

    from repro_torch.kernels import matmul_stats
    from repro_torch.kernels.matmul_stats import matmul_stats_plain

    for m, k, n, dtype in ((100, 500, 300, torch.bfloat16), (64, 100, 96, torch.bfloat16),
                           (33, 65, 129, torch.float32)):
        x = torch.randn((m, k), generator=gen, device=DEVICE).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=DEVICE) * 0.1).to(dtype)
        got = matmul_stats(x, w)
        cpu = [t.to(DEVICE) for t in matmul_stats(x.cpu(), w.cpu())]
        torch.cuda.synchronize()
        dy, rs, rss, ok = ms_compare(x, w, got, cpu)
        print(f"K11 matmul_stats card vs CPU ({m}x{k})@({k}x{n}) {str(dtype)[6:]}: max |dY| "
              f"{dy:.3g}, s {rs:.3g} and ss {rss:.3g} of the row mass (tol {MS_TOL})")
        check(ok, f"K11 card and CPU disagree at ({m}, {k}, {n}) {dtype}")

    def library_moments(xb, wb):
        yl = torch.matmul(xb, wb).float()
        return yl.sum(-1), (yl * yl).sum(-1)

    timed = {}
    for m, dtype in MS_CASES:
        x, w = ms_operands(m, dtype, gen)
        k, n = w.shape
        what = f"({m}x{k})@({k}x{n}) {dtype}"
        before = matmul_stats.launches
        got = matmul_stats(x, w)
        launched = matmul_stats.launches - before
        again = matmul_stats(x, w)
        plain = matmul_stats_plain(x, w)
        torch.cuda.synchronize()
        dy, rs, rss, ok = ms_compare(x, w, got, plain)
        y64, s64, ss64 = _ms_f64(x, w)
        mass_s = y64.abs().sum(-1)
        del y64
        k_s = float(((got[1].double() - s64).abs() / mass_s).max())
        k_ss = float(((got[2].double() - ss64).abs() / ss64).max())
        p_s = float(((plain[1].double() - s64).abs() / mass_s).max())
        p_ss = float(((plain[2].double() - ss64).abs() / ss64).max())
        yr = got[0].double()
        r_s = float(((yr.sum(-1) - s64).abs() / mass_s).max())
        r_ss = float((((yr * yr).sum(-1) - ss64).abs() / ss64).max())
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"K11 matmul_stats {what}: vs plain max |dY| {dy:.3g}, s {rs:.3g} and ss "
              f"{rss:.3g} of the row mass (tol {MS_TOL}); vs the f64 product: kernel s "
              f"{k_s:.3g} / ss {k_ss:.3g}, plain s {p_s:.3g} / ss {p_ss:.3g}, sums of the "
              f"stored Y s {r_s:.3g} / ss {r_ss:.3g}; {launched} launch; repeat bitwise {same}")
        check(ok, f"K11 disagrees with its plain version at {what}")
        check(same, f"K11 {what}: a second launch differs")
        check(launched == 1, f"K11 {what}: {launched} launches for one call")
        check(k_s <= MS_TOL and k_ss <= MS_TOL, f"K11 {what}: moments off the f64 product")
        if dtype == "bfloat16":
            check(r_s > MS_TOL and r_ss > MS_TOL,
                  f"K11 {what}: the stored Y's sums pass the tolerance, which then cannot "
                  "tell them from the accumulator's")
        isz = x.element_size()
        b, by = bound_ms((x.numel() + w.numel() + m * n) * isz + 2 * m * 4,
                         tensor_flops=2 * m * n * k + 2 * 16 * m * n, core_flops=m * n)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        timed[(m, dtype)] = {
            "max_abs_err": dy, "s_err_rel": rs, "ss_err_rel": rss,
            "s_err_vs_f64": k_s, "ss_err_vs_f64": k_ss,
            "ms": device_ms(lambda: matmul_stats(x, w), "matmul_stats_kernel"),
            "call_ms": time_ms(lambda: matmul_stats(x, w), iters=20),
            "plain_ms": device_ms(lambda: matmul_stats_plain(x, w), iters=3),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.matmul(xb, wb)),
            "library_with_moments_ms": device_ms(lambda: library_moments(xb, wb)),
        }
        del x, w, xb, wb, got, again, plain, yr
    main_case = MS_CASES[0]
    results["matmul_stats"] = dict(timed[main_case], serving=timed[MS_CASES[1]],
                                   at_f32=timed[MS_CASES[2]])
    for (m, dtype), t in timed.items():
        print(f"K11 timings ({m} rows, {dtype}): device {t['ms'] * 1e3:.2f} us, call "
              f"{t['call_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.1f} us, torch.matmul "
              f"{t['library_ms'] * 1e3:.2f} us (+ row moments "
              f"{t['library_with_moments_ms'] * 1e3:.2f} us), bound {t['bound_ms'] * 1e3:.2f} us "
              f"by {t['bound_by']}")


def run_matmul_stats_path() -> dict:
    """The K11 entry's main path, every kernel launch counted:
    ``repro_torch.kernels.matmul_stats`` at the three full-width cases (one
    launch each), each output checked: shapes and dtypes, finite values,
    ss >= s^2 / N (Cauchy-Schwarz), and s and ss within ``MS_TOL`` of the
    f64 product's. Returns the launch counts."""
    import torch

    from repro_torch.kernels import common, matmul_stats

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    operands = [ms_operands(m, dtype, gen) for m, dtype in MS_CASES]
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    outs = [matmul_stats(x, w) for x, w in operands]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    print(f"matmul_stats path: {wall * 1e3:.2f} ms for {len(MS_CASES)} calls; launches "
          f"{launches}")
    for (x, w), (y, s, ss) in zip(operands, outs):
        m, n = x.shape[0], w.shape[1]
        check(y.shape == (m, n) and y.dtype == x.dtype and s.shape == ss.shape == (m,)
              and s.dtype == ss.dtype == torch.float32, "matmul_stats path: bad shapes or dtypes")
        check(bool(torch.isfinite(y.float()).all() & torch.isfinite(s).all()
                   & torch.isfinite(ss).all()), "matmul_stats path: non-finite output")
        check(bool(torch.all(ss.double() * (1 + 1e-6) >= s.double() ** 2 / n)),
              "matmul_stats path: ss < s^2 / N")
        y64, s64, ss64 = _ms_f64(x, w)
        mass_s = y64.abs().sum(-1)
        check(float(((s.double() - s64).abs() / mass_s).max()) <= MS_TOL
              and float(((ss.double() - ss64).abs() / ss64).max()) <= MS_TOL,
              "matmul_stats path: moments off the f64 product")
    check(launches["matmul_stats"] == len(MS_CASES),
          f"the matmul_stats path ran {launches['matmul_stats']} K11 launches, expected "
          f"{len(MS_CASES)}")
    return launches


# ------------------------------- model checks --------------------------------


def check_tiny_against_cpu() -> None:
    """Tiny olmo (f32) served on the card with the kernels and on the CPU
    with their plain versions, from the same weights: the same greedy tokens,
    and prefill logits within 1e-3 (f32 sums in other orders; one bf16
    rounding of an intermediate may flip)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine
    from repro_torch.runtime import Request, ServingRuntime

    cfg = get_arch("olmo-1b", tiny=True)
    gpu = GuardedEngine(cfg, 32, 2, seed=0)
    cpu_params = _cpu_copy(gpu.params)
    cpu = GuardedEngine(cfg, 32, 2, device="cpu", params=cpu_params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(12,)).astype(np.int32) for _ in range(3)]
    outs = []
    for eng in (gpu, cpu):
        res = ServingRuntime(eng).serve(
            [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)])
        check(all(r.ok for r in res), "tiny serving failed")
        outs.append([list(r.tokens) for r in res])
    with torch.inference_mode():
        packed = np.stack(prompts[:2]).astype(np.int64)
        lg, _ = gpu._prefill(gpu.params, torch.from_numpy(packed).to(DEVICE))
        lc, _ = cpu._prefill(cpu.params, torch.from_numpy(packed))
    err = float((lg.cpu() - lc).abs().max())
    print(f"tiny olmo f32, card vs CPU: prefill logits max_abs_err {err:.3g} (tol 1e-3); "
          f"greedy tokens equal: {outs[0] == outs[1]}")
    check(outs[0] == outs[1], "tiny olmo: card and CPU tokens differ")
    check(err <= 1e-3, "tiny olmo: card and CPU logits differ")


def _cpu_copy(tree):
    """A detached copy of a parameter tree on the CPU."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    return [_cpu_copy(v) for v in tree]


def serve_full_width() -> dict:
    """Full-width olmo-1b through GuardedEngine + ServingRuntime, every
    kernel launch counted. Returns the launch counts of this run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import common
    from repro_torch.launch.serve import GuardedEngine
    from repro_torch.runtime import Request, ServingRuntime

    censuses = []

    class RecordingEngine(GuardedEngine):
        def start_wave(self, prompts, scales, backend):
            out = super().start_wave(prompts, scales, backend)
            censuses.append(out[2])
            return out

        def decode(self, state, scales, backend):
            out = super().decode(state, scales, backend)
            censuses.append(out[2])
            return out

    cfg = get_arch("olmo-1b")
    t0 = time.time()
    eng = RecordingEngine(cfg, PROMPT + MAX_NEW + 1, SLOTS, seed=0)
    torch.cuda.synchronize()
    print(f"olmo-1b: {cfg.param_count() / 1e9:.3f} B parameters initialised on the card "
          f"in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]
    # warm-up wave (cuBLAS handles, allocator): not counted, not timed
    ServingRuntime(eng).serve([Request(rid=0, prompt=prompts[0], max_new=2)])
    censuses.clear()
    runtime = ServingRuntime(eng)
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    results = runtime.serve([Request(rid=i, prompt=p, max_new=MAX_NEW)
                             for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    snap = runtime.metrics.snapshot()
    n_tok = sum(len(r.tokens) for r in results if r.ok)
    print(f"served {sum(r.ok for r in results)}/{REQUESTS} requests, {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; per-step latency p50 "
          f"{snap['token_latency_p50_s'] * 1e3:.2f} ms p99 "
          f"{snap['token_latency_p99_s'] * 1e3:.2f} ms; breaker_trips "
          f"{snap['breaker_trips']}; launches {launches}")
    check(all(r.ok and len(r.tokens) == MAX_NEW for r in results), "serving did not complete")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.tokens), "token out of range")
    check(snap["breaker_trips"] == 0, "the breaker tripped")
    total_census = float(sum(float(c[-1]) for c in censuses))
    print(f"census total over {len(censuses)} steps: {total_census}")
    check(total_census == 0.0, "non-finite logits in the full-width run")
    per_prefill, per_decode = launches_per_step(cfg.n_layers)
    expected = {k: WAVES * (per_prefill[k] + (MAX_NEW - 1) * per_decode[k])
                for k in per_prefill}
    for k, n in expected.items():
        check(launches[k] == n, f"{k}: {launches[k]} launches, expected {n}")
    check(launches["rmsnorm"] == 0, "rmsnorm is not on the olmo path")
    profile_steps(eng, prompts[:SLOTS])
    return launches


def profile_steps(eng, prompts) -> None:
    """Where a step's time goes: the device's busy time per step (profiler:
    every kernel, memset and copy) against the step's wall time (host clock,
    measured without the profiler), and the kernels that take the most."""
    import torch

    scales = [1.0] * SLOTS
    state, _, _ = eng.start_wave(prompts, scales, "cuda_fused")
    steps = {
        "prefill": lambda: eng.start_wave(prompts, scales, "cuda_fused"),
        # decode re-issued from one committed state: the in-place cache
        # write is idempotent, so every repeat is the same step
        "decode": lambda: eng.decode(state, scales, "cuda_fused"),
    }
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        per_step, _ = launches_per_step(eng.cfg.n_layers)
        expect = {"::row_norm_kernel<": 5 * per_step["layernorm_np"], "::parts_kernel<": 5}
        if name == "prefill":
            expect["::attn_fwd_kernel<"] = 5 * per_step["flash_attention"]
        events = complete_events(lambda: [step() for _ in range(5)], expect, 1,
                                 f"the {name} step")
        busy_ms = sum(us for _, us in events.values()) / 5 / 1e3
        top = sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:6]
        print(f"{name} step (4 slots): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
              f"idle share {max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
        for key, (count, us) in top:
            print(f"    {us / 5 / 1e3:8.4f} ms/step  {count // 5:4d}x  {key[:90]}")


def check_full_width_against_cpu() -> None:
    """Full-width olmo-1b cut to 2 layers: prefill logits and two decode
    steps on the card (kernels) against the CPU (plain versions) from the
    same bf16 weights. Tolerance 0.25 at |logit| ~ 4: the matmuls are bf16
    on both sides with different accumulation orders and roundings."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    gpu = GuardedEngine(cfg, 40, 2, seed=1)
    cpu = GuardedEngine(cfg, 40, 2, device="cpu", params=_cpu_copy(gpu.params))
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int64)
    errs, scale = [], 0.0
    with torch.inference_mode():
        lg, cg = gpu._prefill(gpu.params, torch.from_numpy(prompts).to(DEVICE))
        lc, cc = cpu._prefill(cpu.params, torch.from_numpy(prompts))
        errs.append(float((lg.cpu() - lc).abs().max()))
        scale = float(lc.abs().max())
        tok = torch.argmax(lc, -1)
        for t in range(2):
            lg, cg = gpu._decode_logits(gpu.params, cg, tok.to(DEVICE), 32 + t)
            lc, cc = cpu._decode_logits(cpu.params, cc, tok, 32 + t)
            errs.append(float((lg.cpu() - lc).abs().max()))
            tok = torch.argmax(lc, -1)
    print(f"olmo-1b 2 layers bf16, card vs CPU: logits max_abs_err {errs} at "
          f"|logit| <= {scale:.3g} (tol 0.25)")
    check(max(errs) <= 0.25, "full-width logits: card and CPU differ")


def check_tiny_training_against_cpu() -> None:
    """Tiny olmo (f32), 2 train steps on ``cuda_fused`` with the fused
    second moment, on the card (kernels) and on the CPU (plain versions),
    from the same weights and batches. Loss within 1e-3 (the token sum
    rounds each per-token loss to bf16; one of them a few ulps apart can
    round the other way: 2^-8 x ~6 / 32 tokens), grad norm within 1e-3
    relative (the same roundings of intermediates in f32 math summed in
    other orders; one bf16 rounding of a p may flip), parameters within 1e-5
    (the fused second moment's update is smooth in the gradients: lr x
    relative gradient error)."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import build

    cfg = get_arch("olmo-1b", tiny=True)
    tcfg = TrainConfig(total_steps=2, warmup_steps=1, fused_second_moment=True)
    gparams, gopt, gstep = build(cfg, tcfg, DEVICE)
    cparams, copt, cstep = build(cfg, tcfg, "cpu", params=_cpu_copy(gparams))
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=3)
    for step in (1, 2):
        tokens = torch.from_numpy(data.next()["tokens"])
        gparams, gopt, gm = gstep(gparams, gopt, {"tokens": tokens.to(DEVICE)})
        cparams, copt, cm = cstep(cparams, copt, {"tokens": tokens})
        dp = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(R.tree_leaves(gparams), R.tree_leaves(cparams)))
        dl = abs(float(gm["loss"]) - float(cm["loss"]))
        dg = abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) / float(cm["grad_norm"])
        print(f"tiny olmo training step {step}, card vs CPU: loss {float(gm['loss']):.6f} vs "
              f"{float(cm['loss']):.6f} (|d| {dl:.3g}, tol 1e-3), grad norm rel. diff {dg:.3g} "
              f"(tol 1e-3), params max |d| {dp:.3g} (tol 1e-5)")
        check(dl <= 1e-3 and dg <= 1e-3 and dp <= 1e-5, "tiny olmo training: card and CPU differ")


def check_full_width_training_against_cpu() -> None:
    """Full-width olmo-1b cut to 2 layers, bf16: the step-1 loss and
    gradient norm (the clip statistic's launch) on the card against the CPU
    from the same weights and batch (1 x 32 tokens). Tolerance: loss 0.05,
    grad norm 5% relative -- the matmuls are bf16 in both directions on
    both sides, every activation and gradient element rounded at 2^-9
    relative in other orders (the serving check sees logits 0.035 apart)."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_grads_fn
    from repro_torch.launch.train import build

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    tcfg = TrainConfig()
    gparams, _, _ = build(cfg, tcfg, DEVICE)
    cparams, _, _ = build(cfg, tcfg, "cpu", params=_cpu_copy(gparams))
    tokens = torch.from_numpy(SyntheticLM(cfg.vocab_size, 32, 1, seed=1).next()["tokens"])
    outs = []
    for params, dev in ((gparams, DEVICE), (cparams, "cpu")):
        grads, loss = make_grads_fn(cfg, tcfg)(params, {"tokens": tokens.to(dev)})
        gnorm, _ = optim.global_norm_and_clip(grads, 1.0, backend="cuda_fused")
        outs.append((float(loss), float(gnorm)))
    (lg, gg), (lc, gc) = outs
    print(f"olmo-1b 2 layers bf16 training step, card vs CPU: loss {lg:.5f} vs {lc:.5f} "
          f"(tol 0.05), grad norm {gg:.5g} vs {gc:.5g} (tol 5% relative)")
    check(abs(lg - lc) <= 0.05 and abs(gg - gc) <= 0.05 * gc,
          "full-width training step: card and CPU differ")


def train_full_width() -> dict:
    """Full-width olmo-1b, batch 4 x seq 512, 3 AdamW steps through the
    training CLI's ``main`` (``--reduce-backend cuda_fused``), every kernel
    launch counted; then steps of a fresh model profiled. Returns the
    launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import common
    from repro_torch.launch import train as train_cli

    cfg = get_arch("olmo-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    losses = train_cli.main([
        "--arch", "olmo-1b", "--reduce-backend", "cuda_fused", "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"trained {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {wall:.2f} s "
          f"(initialisation included); losses {losses}; peak device memory {peak:.2f} GiB; "
          f"launches {launches}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "non-finite training loss")
    per_step = train_launches_per_step(cfg.n_layers)
    for k, n in per_step.items():
        check(launches[k] == n * TRAIN_STEPS,
              f"training: {k}: {launches[k]} launches, expected {n * TRAIN_STEPS}")
    params, opt, step_fn = train_cli.build(cfg, TrainConfig(total_steps=10, warmup_steps=1),
                                           DEVICE)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1)
    batches = [{"tokens": torch.from_numpy(data.next()["tokens"]).to(DEVICE)} for _ in range(4)]
    profile_train_step(step_fn, params, opt, batches)
    return launches


def profile_train_step(step_fn, params, opt, batches) -> None:
    """Where a training step's time goes: wall time on the host clock
    (without the profiler) against the device's busy time (profiler: every
    kernel, memset and copy, from a session whose kernel counts match the
    step's launches), and the device items that take the most."""
    import torch

    from repro_torch.configs import get_arch

    params, opt, _ = step_fn(params, opt, batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[1:3]:
        params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    n = train_launches_per_step(get_arch("olmo-1b").n_layers)
    expect = {"::row_norm_kernel<": n["layernorm_np"], "::attn_fwd_kernel<": n["flash_attention"],
              "::ce_kernel<": n["cross_entropy"], "::fused_sum_kernel<": n["mma_sum_fused"],
              "::parts_kernel<": n["mma_sum_parts"]}
    events = complete_events(lambda: step_fn(params, opt, batches[3]), expect, 1,
                             "the training step")
    busy_ms = sum(us for _, us in events.values()) / 1e3
    print(f"train step (4 x 512 tokens): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    for key, (count, us) in sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:10]:
        print(f"    {us / 1e3:9.4f} ms/step  {count:5d}x  {key[:90]}")


# ----------------------------------- main ------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    build.library()
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc, {len(build.SOURCES)} sources in parallel)")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results: dict = {}
    check_norms(results, gen)
    check_attention(results, gen)
    check_parts(results, gen)
    check_cross_entropy(results, gen)
    check_fused_sum(results, gen)
    check_tile_partials(results, gen)
    check_moments_and_kahan(results, gen)
    check_reduce_against_cpu(gen)
    check_auto_route(gen)
    torch.cuda.empty_cache()
    check_backward_times(results, gen)
    check_tiny_against_cpu()
    check_full_width_against_cpu()
    serve_launches = serve_full_width()

    from repro_torch import reduce as R

    R.set_default_backend("cuda_fused")  # the training CLI's --reduce-backend cuda_fused
    try:
        check_tiny_training_against_cpu()
        check_full_width_training_against_cpu()
        check_parts_training(results, gen)
        train_launches = train_full_width()
    finally:
        R.set_default_backend(None)
    torch.cuda.empty_cache()
    check_segments(results, gen)
    torch.cuda.empty_cache()
    check_scan(results, gen)
    torch.cuda.empty_cache()
    check_parts_bf16(results, gen)
    check_multi_against_cpu(gen)
    check_packing_offsets(gen)
    torch.cuda.empty_cache()
    multi_launches = run_multi_reduce_path()
    torch.cuda.empty_cache()
    paper_launches = run_reduce_demo()
    torch.cuda.empty_cache()
    check_matmul_stats(results, gen)
    ms_launches = run_matmul_stats_path()

    kernels = []
    for name in KERNELS:
        r = results[name]
        main_path = (paper_launches if name in PAPER_KERNELS else
                     multi_launches if name in MULTI_KERNELS else
                     ms_launches if name == "matmul_stats" else train_launches)
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": main_path[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "call_ms": r["call_ms"],
            "launches_training": train_launches[name],
            "launches_serving": serve_launches[name], "launches_paper": paper_launches[name],
            "launches_multi_reduce": multi_launches[name],
            "launches_matmul_stats": ms_launches[name],
        }
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.1f} us"
        shape = ("2^28 f32" if k["name"] in PAPER_KERNELS + MULTI_KERNELS
                 else "(2048x8192)@(8192x2048) bf16" if k["name"] == "matmul_stats"
                 else "the training shape")
        print(f"{k['name']}: device {k['ms'] * 1e3:.2f} us per call at {shape} "
              f"(whole call {k['call_ms'] * 1e3:.1f} us; plain {k['plain_ms'] * 1e3:.1f} us, "
              f"library {lib}, bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}), "
              f"launches: {k['launches_training']} in training, {k['launches_serving']} in "
              f"serving, {k['launches_paper']} in the paper's demo, "
              f"{k['launches_multi_reduce']} in the multi-reduce path, "
              f"{k['launches_matmul_stats']} in the matmul_stats path")
    print(f"backward passes (torch math): {results['backward']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
