#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the serving path's
full-width shapes (olmo-1b: d_model 2048, 16 heads of 128, vocab 50304,
bf16) and times it, checks a tiny model end to end against the CPU, then
serves full-width olmo-1b through the guarded runtime (8 requests, prompt
256, 16 new tokens, 4 slots) with every kernel launch counted. Exits
nonzero, with no result line, when any check fails or there is no GPU.

Output: the card's name and power limit (nvidia-smi), the build time, one
line per kernel check, the serving figures, then the kernels JSON line and,
last, ``{"ok": true, "device": {...}}``.

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


def launches_per_step(n_layers: int):
    """Kernel launches per prefill and per decode step: two norms per layer
    plus the final norm, prefill attention per layer, one logit statistic."""
    prefill = {"layernorm_np": 2 * n_layers + 1, "flash_attention": n_layers,
               "mma_sum_parts": 1}
    decode = dict(prefill, flash_attention=0)
    return prefill, decode


TPU_KERNELS = {
    "layernorm_np": "src/repro/kernels/row_moments/kernel.py:57",
    "rmsnorm": "src/repro/kernels/row_moments/kernel.py:47",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:50",
    "mma_sum_parts": "src/repro/kernels/mma_reduce/kernel.py:728",
}
SOURCES = {
    "layernorm_np": "src/repro_torch/kernels/csrc/row_moments.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/row_moments.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "mma_sum_parts": "src/repro_torch/kernels/csrc/parts_reduce.cu",
}


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


def device_ms(fn, match: str | None = None, iters: int = 20, warmup: int = 3,
              tries: int = 3) -> float:
    """Mean DEVICE time of one call: the profiler's device time of every
    kernel, memset and copy the call runs, over ``iters`` calls. Inputs stay
    resident in L2 (each is at most 17 MB), as on the serving path, where
    the producer of a kernel's input has just written it. With ``match``,
    the call must have run a kernel whose name contains it. A profiling
    session that records no device time is run again, up to ``tries``
    sessions in all; then the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    what = match or getattr(fn, "__qualname__", "the call")
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total_us = sum(_self_device_us(e) for e in events)
        if total_us > 0.0:
            if match is not None:
                check(any(match in e.key and _self_device_us(e) > 0.0 for e in events),
                      f"the profiler recorded no device time for a kernel named {match}")
            return total_us / iters / 1e3
        print(f"profiling session {attempt} of {what} recorded no device time "
              f"({len(events)} events)")
    raise SmokeFailure(f"the profiler recorded no device time for {what} in {tries} sessions")


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
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import layernorm_np, rmsnorm
    from repro_torch.kernels.row_moments import layernorm_np_plain, rmsnorm_plain

    d = 2048
    for rows in (SLOTS, SLOTS * PROMPT):  # decode rows, then prefill rows (timed)
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
    nbytes = 2 * x.numel() * 2
    mma = x.numel() * 16  # m16n8k16 ones-MMA: 16 flops per element per statistic
    b_ln, by_ln = bound_ms(nbytes, tensor_flops=2 * mma, core_flops=6 * x.numel())
    b_rn, by_rn = bound_ms(nbytes + d * 2, tensor_flops=mma, core_flops=5 * x.numel())
    rms_lib = getattr(F, "rms_norm", None)
    results["layernorm_np"] = {
        "max_abs_err": err_ln,
        "ms": device_ms(lambda: layernorm_np(x, 1e-5), "row_norm_kernel"),
        "call_ms": time_ms(lambda: layernorm_np(x, 1e-5)),
        "plain_ms": device_ms(lambda: layernorm_np_plain(x, 1e-5)),
        "bound_ms": b_ln, "bound_by": by_ln,
        "library_ms": device_ms(lambda: F.layer_norm(x, (d,), eps=1e-5)),
    }
    results["rmsnorm"] = {
        "max_abs_err": err_rn,
        "ms": device_ms(lambda: rmsnorm(x, gamma, 1e-6), "row_norm_kernel"),
        "call_ms": time_ms(lambda: rmsnorm(x, gamma, 1e-6)),
        "plain_ms": device_ms(lambda: rmsnorm_plain(x, gamma, 1e-6)),
        "bound_ms": b_rn, "bound_by": by_rn,
        "library_ms": (device_ms(lambda: rms_lib(x, (d,), gamma, 1e-6))
                       if rms_lib is not None else None),
    }


def _causal_pairs(sq: int, skv: int, q_offset: int, window) -> int:
    """(query, key) pairs the masks leave visible."""
    n = 0
    for i in range(sq):
        qp = q_offset + i
        lo = 0 if window is None else max(0, qp - window + 1)
        n += max(0, min(qp, skv - 1) - lo + 1)
    return n


def check_attention(results: dict, gen) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    cases = [  # b, hq, hkv, sq, skv, d, causal, window, q_offset
        (SLOTS, 16, 16, PROMPT, PROMPT, 128, True, None, 0),  # the prefill shape (timed)
        (1, 16, 4, 64, 320, 128, True, 128, 256),              # GQA + window + q_offset
        (2, 4, 2, 100, 100, 64, False, None, 0),               # ragged, non-causal
    ]
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
              "(tol: 2 bf16 ulps of the output -- the same 64-key blocks, f32 sums in "
              "another order, which can flip one bf16 rounding of p)")
        check(bool(torch.isfinite(out.float()).all()), f"flash_attention non-finite at {case}")
        check(bool(torch.all((out.float() - plain.float()).abs()
                             <= 2.0**-6 * plain.float().abs() + 2e-3)),
              f"flash_attention disagrees with its plain version at {case}")
    pairs = _causal_pairs(PROMPT, PROMPT, 0, None) * SLOTS * 16
    b_fa, by_fa = bound_ms(4 * q.numel() * 2, tensor_flops=4 * 128 * pairs, core_flops=pairs)
    results["flash_attention"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: flash_attention(q, k, v, causal=True), "attn_fwd_kernel"),
        "call_ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5),
        "bound_ms": b_fa, "bound_by": by_fa,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
    }


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

    results["mma_sum_parts"] = {
        "max_abs_err": err,
        "ms": device_ms(k4, "parts_kernel"),
        "call_ms": time_ms(k4),
        "plain_ms": device_ms(lambda: mma_sum_parts_plain(parts, ("square",) * SLOTS, chains,
                                                          True), iters=5),
        "bound_ms": b_k4, "bound_by": by_k4,
        "library_ms": device_ms(lambda: logits.square().sum(-1)),
    }


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
    cpu_params = _to_device(gpu.params, "cpu")
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


def _to_device(tree, device):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return [_to_device(v, device) for v in tree]


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
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy_ms = sum(_self_device_us(e) for e in events) / 5 / 1e3
        top = sorted(events, key=_self_device_us, reverse=True)[:6]
        print(f"{name} step (4 slots): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
              f"idle share {max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
        for e in top:
            print(f"    {_self_device_us(e) / 5 / 1e3:8.4f} ms/step  {e.count // 5:4d}x  {e.key[:90]}")


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
    cpu = GuardedEngine(cfg, 40, 2, device="cpu", params=_to_device(gpu.params, "cpu"))
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
    check_tiny_against_cpu()
    check_full_width_against_cpu()
    launches = serve_full_width()

    kernels = []
    for name in ("mma_sum_parts", "layernorm_np", "rmsnorm", "flash_attention"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "call_ms": r["call_ms"],
        })
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.1f} us"
        print(f"{k['name']}: device {k['ms'] * 1e3:.2f} us per launch (whole call "
              f"{k['call_ms'] * 1e3:.1f} us; plain {k['plain_ms'] * 1e3:.1f} us, library {lib}, "
              f"bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}), "
              f"{k['launches']} launches on the path")
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
