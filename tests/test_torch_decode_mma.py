"""The decode step's ``mma_reductions`` flag: the port's ``decode_attention``
reduces its softmax denominator on ``backend_for_flags(mma)`` and
``self_attention_decode`` passes ``mma=cfg.mma_reductions``, as the
reference does (``repro/models/attention.py`` ``decode_attention``).

Tiny olmo decode steps on the CPU record the backend that the
denominator's ``reduce`` receives, with the paper's technique on and off.
Then the port's ``decode_attention(mma=...)`` is held against the
reference's on the same numpy-seeded inputs. Tolerance: the
``tests/harness.py`` budget of the denominator's multiplier width
(``COMPUTE_REL``: bf16 with ``mma``, f32 without) times the largest |v|,
a bound on the output's error per unit of its softmax mass; both sides
round the same operands to bf16 and differ only in summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import COMPUTE_REL
from repro import reduce as ref_R
from repro.models.attention import decode_attention as ref_decode_attention
from repro_torch import reduce as R
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import model as M

B, S_MAX, PROMPT = 2, 12, 5


def _decode_backends(monkeypatch, mma: bool) -> list:
    """The backends the denominators' ``reduce`` calls receive over three
    tiny olmo decode steps."""
    cfg = dataclasses.replace(get_arch("olmo-1b", tiny=True), mma_reductions=mma)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen, inside = [], [False]
    decode, reduce = A.decode_attention, R.reduce

    def spy_decode(*args, **kw):
        inside[0] = True
        try:
            return decode(*args, **kw)
        finally:
            inside[0] = False

    def spy_reduce(x, *args, **kw):
        if inside[0]:
            seen.append(kw.get("backend"))
        return reduce(x, *args, **kw)

    monkeypatch.setattr(A, "decode_attention", spy_decode)
    monkeypatch.setattr(R, "reduce", spy_reduce)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, PROMPT)))
    with torch.inference_mode():
        caches = M.make_caches(cfg, B, S_MAX, "cpu")
        logits, caches = M.prefill(params, cfg, tokens, caches)
        for t in range(3):
            tok = logits.argmax(-1)
            logits, caches = M.decode_step(params, cfg, tok, caches, PROMPT + t)
            assert bool(torch.isfinite(logits).all())
    return seen


@pytest.mark.parametrize("mma", [True, False], ids=["mma-on", "mma-off"])
def test_decode_denominator_backend_follows_mma_reductions(monkeypatch, mma):
    seen = _decode_backends(monkeypatch, mma)
    n_layers = get_arch("olmo-1b", tiny=True).n_layers
    assert len(seen) == 3 * n_layers
    assert set(seen) == {R.backend_for_flags(mma)}
    if not mma:
        assert R.backend_for_flags(False) == "torch"


def _decode_inputs(seed=0, b=2, h=4, hkv=2, d=16, s_max=24, pos=17):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    slot_pos = np.full((s_max,), -1, np.int32)
    slot_pos[:pos + 1] = np.arange(pos + 1)
    return q, k, v, slot_pos, pos


@pytest.mark.parametrize("mma", [True, False], ids=["mma-on", "mma-off"])
def test_decode_attention_matches_reference(mma):
    q, k, v, slot_pos, pos = _decode_inputs()
    want = np.asarray(ref_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slot_pos),
        jnp.asarray(pos, jnp.int32), mma=mma))
    got = A.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(slot_pos), pos, mma=mma)
    assert got.shape == want.shape and got.dtype == torch.float32
    compute = "bfloat16" if mma else "float32"
    assert ref_R.backend_for_flags(mma) == ("mma_jnp" if mma else "xla")
    tol = COMPUTE_REL[compute] * float(np.abs(v).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
