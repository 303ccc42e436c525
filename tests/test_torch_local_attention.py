"""Port parity of local attention with ring caches (``models.attention``'s
``window=`` and the ring branch of ``fill_kv_cache``), against
``repro.models.attention`` and against the port's own teacher-forcing
forward.

  * ``fill_kv_cache`` at prompts shorter than, equal to and longer than a
    16-slot ring: the keys, values and ``slot_pos`` the reference's ring
    branch keeps (the last 16 positions, position p at slot p % 16);
  * ``decode_attention(window=)`` against the reference's, and equal to
    the same call with the out-of-window slots emptied;
  * ``self_attention_decode``: a ring wraps at slot pos % slots; a full
    cache, or a ring shorter than the window, refuses a position past it;
  * the port of ``tests/test_serving_consistency.py::
    test_ring_cache_eviction_is_exact``: tiny recurrentgemma (window 16) at
    S = 3 x 16 + 5, the prompt's S - 1 tokens prefilled and the last one
    decoded, against ``forward``'s last logits; then a prefill of 2 x 16 +
    3 and a decode of every further token, each against ``forward``: on
    the kernel route (the plain versions here) and the non-kernel route;
  * a planted fault -- the ring filled at slot p instead of p % 16, which
    keeps the prompt's first 16 positions, as a cache without the ring
    would -- must fail that limit.

Tolerances: the cache contents 4e-6 at |k| up to ~4 (f32 projections
and RoPE, sums of other orders; observed 1.1e-6) and ``slot_pos`` exactly; the windowed decode 1e-5; the
eviction test the reference's 2e-3 absolute + 1e-3 relative (observed
~3e-6 on both routes: the decode and the forward sum in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import attention as RA
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import decode_step, forward, init_params, make_caches, prefill
from repro_torch.models.convert import tensor_from_numpy

ARCH = "recurrentgemma-9b"
ATOL, RTOL = 2e-3, 1e-3


def _rng(seed=0):
    return np.random.default_rng(seed)


def _attn(seed=0):
    rcfg = ref_arch(ARCH, tiny=True)
    pcfg = get_arch(ARCH, tiny=True)
    rp, _ = RA.attn_init(jax.random.PRNGKey(seed), rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads,
                         rcfg.d_head, jnp.float32)
    pp = {k: {"w": tensor_from_numpy(np.asarray(v["w"]))} for k, v in rp.items()}
    return rcfg, pcfg, rp, pp


@pytest.mark.parametrize("s", [10, 16, 37])
def test_fill_kv_cache_ring_matches_reference(s):
    rcfg, pcfg, rp, pp = _attn(1)
    ring = pcfg.window
    x = _rng(s).standard_normal((2, s, pcfg.d_model)).astype(np.float32)
    positions = np.tile(np.arange(s), (2, 1))
    want = RA.fill_kv_cache(rp, jnp.asarray(x), jnp.asarray(positions),
                            RA.make_kv_cache(2, ring, 1, 16, jnp.float32), rcfg)
    cache = A.make_kv_cache(2, ring, 1, 16, torch.float32, "cpu")
    with torch.no_grad():
        _, k, v = A.self_attention_train(pp, torch.from_numpy(x), torch.from_numpy(positions),
                                         pcfg, window=ring, return_kv=True)
    got = A.fill_kv_cache(cache, k, v)
    assert got is cache  # written in place
    np.testing.assert_array_equal(cache["slot_pos"].numpy(), np.asarray(want["slot_pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(want[key]), rtol=0, atol=4e-6)
    if s > ring:
        assert sorted(cache["slot_pos"].tolist()) == list(range(s - ring, s))
        assert all(p % ring == i for i, p in enumerate(cache["slot_pos"].tolist()))


@pytest.mark.parametrize("window", [None, 12])
def test_windowed_decode_attention_matches_reference(window):
    rng = _rng(3)
    b, h, hkv, d, n, pos = 2, 4, 1, 16, 16, 35
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, n, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, n, hkv, d)).astype(np.float32)
    slot_pos = np.empty(n, np.int32)  # positions 20..35, each at slot p % 16
    slot_pos[np.arange(20, 36) % n] = np.arange(20, 36)
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(slot_pos), jnp.asarray(pos), window=window)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    sp = torch.from_numpy(slot_pos)
    got = A.decode_attention(*t, sp, pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if window is not None:
        emptied = torch.where(pos - sp < window, sp, -1)
        assert torch.equal(got, A.decode_attention(*t, emptied, pos))
        assert not torch.equal(got, A.decode_attention(*t, sp, pos))


def test_decode_writes_the_ring_slot_and_refuses_past_a_full_cache():
    _, pcfg, _, pp = _attn(2)
    x = torch.from_numpy(_rng(4).standard_normal((2, 1, pcfg.d_model)).astype(np.float32))
    ring = A.make_kv_cache(2, 8, 1, 16, torch.float32, "cpu")
    with torch.no_grad():
        for pos in range(8, 21):
            A.self_attention_decode(pp, x, ring, pos, pcfg, window=8)
            assert int(ring["slot_pos"][pos % 8]) == pos
        full = A.make_kv_cache(2, 8, 1, 16, torch.float32, "cpu")
        with pytest.raises(ValueError, match="past the cache length"):
            A.self_attention_decode(pp, x, full, 8, pcfg)
        # a ring shorter than the window would evict a key still in sight
        with pytest.raises(ValueError, match="past the cache length"):
            A.self_attention_decode(pp, x, A.make_kv_cache(2, 8, 1, 16, torch.float32, "cpu"),
                                    8, pcfg, window=16)


def _fill_at_slot_pos(cache, k, v, slot0=0):
    """A planted fault: the ring filled at slot pos instead of pos % s_max,
    as a cache without the ring would be -- a long prompt keeps its FIRST
    s_max positions, each at slot p, and loses the most recent ones."""
    s_max = cache["k"].shape[1]
    return REAL_FILL(cache, k[:, :s_max], v[:, :s_max], slot0)


REAL_FILL = A.fill_kv_cache


def _decode_against_forward(cfg, params, toks, prompt: int) -> float:
    """Prefill ``prompt`` tokens, decode every further one; the largest
    excess of |decode - forward| over the limit (<= 0: within it)."""
    b, s = toks.shape
    with torch.inference_mode():
        want, _ = forward(params, cfg, toks)
        logits, caches = prefill(params, cfg, toks[:, :prompt], make_caches(cfg, b, s, "cpu"))
        worst = float(((logits - want[:, prompt - 1:prompt]).abs()
                       - (ATOL + RTOL * want[:, prompt - 1:prompt].abs())).max())
        for pos in range(prompt, s):
            logits, caches = decode_step(params, cfg, toks[:, pos:pos + 1], caches, pos)
            lim = ATOL + RTOL * want[:, pos:pos + 1].abs()
            worst = max(worst, float(((logits - want[:, pos:pos + 1]).abs() - lim).max()))
    return worst


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "nonkernel_route"])
def test_ring_cache_eviction_is_exact(use_kernels, monkeypatch):
    cfg = dataclasses.replace(get_arch(ARCH, tiny=True), use_kernels=use_kernels)
    w = cfg.window
    s = 3 * w + 5
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_rng(1).integers(0, cfg.vocab_size, (2, s)))
    # the reference's form: S - 1 tokens prefilled, the last one decoded
    assert _decode_against_forward(cfg, params, toks, s - 1) <= 0
    # a prefill past the window, then decode steps wrapping the ring twice
    assert _decode_against_forward(cfg, params, toks, 2 * w + 3) <= 0
    monkeypatch.setattr(A, "fill_kv_cache", _fill_at_slot_pos)
    assert _decode_against_forward(cfg, params, toks, s - 1) > 0
