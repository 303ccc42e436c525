"""Port parity of the guarded serving path on tiny olmo-1b.

The reference is ``repro.launch.serve.GuardedEngine`` on
``dataclasses.replace(cfg, use_pallas=True)`` (Pallas kernels in interpret
mode); the port is ``repro_torch.launch.serve.GuardedEngine`` on the CPU,
given the reference's own weights through ``params_from_jax``.

Tolerances: in f32 (tiny olmo's dtype) both sides round to bf16 at the same
points (the norms' statistics, attention's q/k/v and p) and sum in
different orders, so one bf16 ulp of an intermediate may flip: logits agree
within 1e-4 at |logit| ~3 (observed ~2e-6). The bf16 variant adds the
frameworks' own bf16 rounding of elementwise ops (silu, residual adds),
which differs between XLA and PyTorch: 0.15 there (observed ~0.05).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.launch.serve import GuardedEngine as RefEngine
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.runtime import Request as RefRequest
from repro.runtime import ServingRuntime as RefRuntime
from repro_torch.configs import get_arch
from repro_torch.launch.serve import Engine, GuardedEngine
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.runtime import ChaosMonkey, Request, ServingRuntime

SLOTS, PROMPT, S_MAX = 2, 8, 16
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 0.15}


def _engines(dtype="float32", seed=0):
    rcfg = dataclasses.replace(ref_arch("olmo-1b", tiny=True), use_pallas=True, dtype=dtype)
    pcfg = dataclasses.replace(get_arch("olmo-1b", tiny=True), dtype=dtype)
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=seed)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    return reng, GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)


def _prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(PROMPT,)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(dtype):
    reng, peng = _engines(dtype)
    prompts = np.stack(_prompts(SLOTS))
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(prompts))
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(prompts.astype(np.int64)))
    assert got.shape == want.shape == (SLOTS, 1, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL[dtype])
    # teacher-forced decode: the same tokens into both caches
    rdec = jax.jit(ref_decode_step(reng.cfg, greedy=False))
    toks = np.random.default_rng(2).integers(0, 256, size=(3, SLOTS, 1))
    for t in range(3):
        pos = PROMPT + t
        want, rcache = rdec(reng.params, rcache, jnp.asarray(toks[t], jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            got, pcache = peng._decode_logits(peng.params, pcache, torch.from_numpy(toks[t]), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL[dtype])


def _serve(runtime_cls, request_cls, engine, prompts, max_new=4):
    runtime = runtime_cls(engine)
    results = runtime.serve([request_cls(rid=i, prompt=p, max_new=max_new)
                             for i, p in enumerate(prompts)])
    assert all(r.ok for r in results)
    return [list(r.tokens) for r in results], runtime


def test_greedy_tokens_match_reference():
    reng, peng = _engines()
    prompts = _prompts(3)
    want, _ = _serve(RefRuntime, RefRequest, reng, prompts)
    got, runtime = _serve(ServingRuntime, Request, peng, prompts)
    assert got == want
    assert runtime.metrics.snapshot()["breaker_trips"] == 0


def test_chaos_run_equals_clean_run_bitwise():
    _, peng = _engines()
    prompts = _prompts(8, seed=3)
    clean, _ = _serve(ServingRuntime, Request, peng, prompts)
    chaos = ChaosMonkey.from_seed(7, n_steps=8, nan_rate=0.15, fail_rate=0.15,
                                  preempt_rate=0.1)
    assert chaos.nan_steps or chaos.fail_steps  # the schedule injects something
    runtime = ServingRuntime(peng, chaos=chaos)
    results = runtime.serve([Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    assert [list(r.tokens) for r in results] == clean
    assert runtime.metrics.snapshot()["retries"] > 0


def test_retried_decode_step_is_idempotent():
    """Caches are written in place: a step re-issued from the committed
    state must give the same tokens, census and caches, bitwise."""
    _, peng = _engines()
    state, _, _ = peng.start_wave(_prompts(SLOTS), [1.0] * SLOTS, "cuda_fused")
    s1, tok1, cen1 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    snap = [c["k"].clone() for c in s1["caches"]["layers"]]
    s2, tok2, cen2 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_array_equal(cen1, cen2)
    for a, c in zip(snap, s2["caches"]["layers"]):
        assert torch.equal(a, c["k"])
    # a poisoned attempt (NaN scale) leaves the retry bitwise clean too
    _, _, cen_bad = peng.decode(state, [float("nan")] + [1.0] * (SLOTS - 1), "cuda_fused")
    assert cen_bad[0] > 0 and cen_bad[-1] == cen_bad[0]
    _, tok3, cen3 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    np.testing.assert_array_equal(tok1, tok3)
    np.testing.assert_array_equal(cen1, cen3)


def test_param_count_matches_reference():
    assert get_arch("olmo-1b").param_count() == ref_arch("olmo-1b").param_count()
    assert get_arch("olmo-1b", tiny=True).param_count() == ref_arch("olmo-1b", tiny=True).param_count()


def test_params_from_jax_bf16_round_trip_is_bitwise():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    a[0, 0] = np.nan
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    back = t.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(back, a.view(np.uint16))
    # the whole tree of a bf16 config crosses bit for bit
    reng, peng = _engines("bfloat16")
    ref_q = np.asarray(reng.params["units"]["pos0"]["mix"]["q"]["w"][1])
    got_q = peng.params["layers"][1]["mix"]["q"]["w"]
    np.testing.assert_array_equal(got_q.view(torch.int16).numpy().view(np.uint16),
                                  ref_q.view(np.uint16))


def test_engine_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_arch("olmo-1b", tiny=True), S_MAX, SLOTS)


def test_non_kernel_attention_route_not_ported():
    """The non-kernel route (``use_kernels=False``: the chunked
    ``flash_attention_xla`` and the engine's norm statistics) now serves:
    from the same weights it gives the kernel route's greedy tokens (tiny
    olmo in f32; the two routes round the same operands to bf16)."""
    cfg = get_arch("olmo-1b", tiny=True)
    kernel = Engine(cfg, S_MAX, SLOTS, device="cpu")
    plain = Engine(dataclasses.replace(cfg, use_kernels=False), S_MAX, SLOTS, device="cpu",
                   params=kernel.params)
    prompts = _prompts(3)
    assert plain.serve(prompts, 4) == kernel.serve(prompts, 4)
