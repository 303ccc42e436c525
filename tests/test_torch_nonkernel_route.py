"""The dense block's non-kernel route (``use_kernels=False``), held against
the reference's default route (``use_pallas=False``), with the paper's
technique on (``mma_reductions``: ``mma_torch`` against ``mma_jnp``) and
off (``torch`` against ``xla``).

  * ``norm_apply(mma=)`` for rmsnorm, layernorm and layernorm_np;
  * ``flash_attention_xla`` (causal, ``window``, ``q_offset``, ragged
    chunks) and its gradient against ``jax.grad``;
  * tiny olmo ``forward`` logits and ``lm_loss`` from the reference's own
    ``init_params`` (carried over by ``params_from_jax``); ``prefill`` and
    ``decode_step`` on this route; a train step's gradients;
  * the chunked attention under ``torch.utils.checkpoint``: the backward
    pass recomputes each chunk.

Tolerances (inputs and tiny olmo are f32):
  * norms 2e-5 absolute on outputs of unit scale: both sides take the same
    row statistics (bf16 multipliers with the technique on, f32 off) and
    differ only in summation order;
  * attention 2e-5 (outputs of unit scale): the same bf16-rounded
    operands, f32 sums in other orders (observed < 2e-6). Gradients also
    one bf16 ulp (2^-7 relative): both sides round each operand's cotangent to bf16 (the
    transpose of the operand cast), and an f32 sum a few ulps apart can
    round to the neighbouring bf16 value (observed: 1 of 2368 elements);
  * logits 5e-3, the loss 1e-4, each gradient leaf 2^-6 of its largest
    entry: the models agree bitwise on whole sequences, and where an f32
    sum a few ulps apart flips one bf16 rounding of an attention operand
    (2^-8 of it), the later positions and layers carry that step (observed:
    logits 1.6e-3, loss 1.8e-5, gradients 2^-8 of the leaf).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import losses as ref_losses
from repro.models.attention import flash_attention_xla as ref_flash_attention_xla
from repro.models.layers import norm_apply as ref_norm_apply
from repro_torch import models
from repro_torch import reduce as R
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax

MMA = [True, False]
MMA_IDS = ["mma", "plain"]


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norm_apply_matches_reference(kind, mma):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 96)) * 2 + 0.5).astype(np.float32)
    p = {}
    if kind in ("rmsnorm", "layernorm"):
        p["scale"] = (rng.random(96) + 0.5).astype(np.float32)
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(96).astype(np.float32)
    want = ref_norm_apply(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                          eps=1e-5, mma=mma)
    got = L.norm_apply(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), eps=1e-5, mma=mma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
def test_norm_apply_backend_follows_mma(monkeypatch, mma):
    """The row statistics go through ``reduce(axis=-1)`` on
    ``backend_for_flags(mma)``; rmsnorm's sumsq at bf16 multipliers on the
    MMA route."""
    seen = []
    reduce = R.reduce

    def spy(x, *args, **kw):
        seen.append((kw.get("kind"), kw.get("backend"), kw.get("compute_dtype")))
        return reduce(x, *args, **kw)

    monkeypatch.setattr(R, "reduce", spy)
    x = torch.randn(4, 32)
    L.norm_apply("rmsnorm", {"scale": torch.ones(32)}, x, eps=1e-6, mma=mma)
    L.norm_apply("layernorm_np", {}, x, eps=1e-6, mma=mma)
    backend = "mma_torch" if mma else "torch"
    assert seen == [("sumsq", backend, "bfloat16" if mma else None),
                    ("moments", backend, None)]


def test_norm_apply_bf16_applies_in_activation_dtype():
    x = torch.randn(5, 64).to(torch.bfloat16)
    y = L.norm_apply("layernorm_np", {}, x, eps=1e-5, mma=True)
    assert y.dtype == torch.bfloat16
    want = torch.nn.functional.layer_norm(x.float(), (64,), eps=1e-5)
    assert float((y.float() - want).abs().max()) <= 0.05  # a few bf16 ulps at |y| ~ 3


ATTN_CASES = [
    # (sq, skv, h, hkv, d, causal, window, q_offset, q_chunk, kv_chunk)
    (40, 40, 4, 2, 16, True, None, 0, 16, 16),
    (40, 40, 4, 4, 16, False, None, 0, 512, 1024),
    (37, 53, 4, 1, 8, True, 12, 16, 16, 24),
    (24, 64, 2, 2, 16, True, None, 40, 10, 16),
]


def _attn_inputs(sq, skv, h, hkv, d, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_xla_matches_reference(case, mma):
    sq, skv, h, hkv, d, causal, window, q_offset, qc, kc = case
    q, k, v = _attn_inputs(sq, skv, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=qc, kv_chunk=kc, mma=mma)
    want = ref_flash_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = A.flash_attention_xla(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", ATTN_CASES[::2], ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_xla_gradient_matches_reference(case):
    sq, skv, h, hkv, d, causal, window, q_offset, qc, kc = case
    q, k, v = _attn_inputs(sq, skv, h, hkv, d, seed=2)
    g = np.random.default_rng(3).standard_normal((2, sq, h, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=qc, kv_chunk=kc)
    want = jax.grad(lambda a, b, c: jnp.sum(ref_flash_attention_xla(a, b, c, **kw) * g),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = A.flash_attention_xla(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=2**-7, atol=2e-5)


def test_flash_attention_xla_recomputes_each_kv_chunk(monkeypatch):
    """Each kv chunk runs under ``torch.utils.checkpoint``: the backward
    pass calls every chunk's block a second time; without grad, once."""
    calls = []
    block = A._online_block

    def spy(*args, **kw):
        calls.append(1)
        return block(*args, **kw)

    monkeypatch.setattr(A, "_online_block", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _attn_inputs(32, 32, 2, 2, 8))
    out = A.flash_attention_xla(q, k, v, q_chunk=16, kv_chunk=8)
    assert len(calls) == 2 * 4
    out.sum().backward()
    assert len(calls) == 2 * 2 * 4
    calls.clear()
    with torch.no_grad():
        A.flash_attention_xla(q, k, v, q_chunk=16, kv_chunk=8)
    assert len(calls) == 2 * 4


def _tiny(mma):
    rcfg = dataclasses.replace(ref_arch("olmo-1b", tiny=True), use_pallas=False,
                               mma_reductions=mma)
    pcfg = dataclasses.replace(get_arch("olmo-1b", tiny=True), use_kernels=False,
                               mma_reductions=mma)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    tokens = np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, 24)).astype(np.int32)
    return rcfg, pcfg, rparams, pparams, tokens


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
def test_tiny_olmo_forward_and_loss_match_reference(mma):
    rcfg, pcfg, rparams, pparams, tokens = _tiny(mma)
    rlogits, raux = ref_forward(rparams, rcfg, jnp.asarray(tokens[:, :-1]))
    rloss, _ = ref_losses.lm_loss(rlogits, jnp.asarray(tokens[:, 1:]), raux, rcfg)
    with torch.no_grad():
        plogits, paux = models.forward(pparams, pcfg, torch.from_numpy(tokens[:, :-1]).long())
        ploss, parts = models.losses.lm_loss(plogits, torch.from_numpy(tokens[:, 1:]).long(),
                                             paux, pcfg)
    assert plogits.shape == rlogits.shape == (2, 23, pcfg.vocab_size)
    assert paux.dtype == torch.float32 and float(paux) == 0.0
    np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits), rtol=0, atol=5e-3)
    assert abs(float(ploss) - float(rloss)) <= 1e-4
    assert float(parts["ce"]) == float(ploss)


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
def test_tiny_olmo_cross_entropy_tokens_match_reference(mma):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((3, 5, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (3, 5)).astype(np.int32)
    want = ref_losses.cross_entropy_tokens(jnp.asarray(logits), jnp.asarray(labels), mma=mma)
    got = models.losses.cross_entropy_tokens(torch.from_numpy(logits),
                                             torch.from_numpy(labels), mma=mma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
def test_tiny_olmo_prefill_and_decode_on_the_route(mma):
    """``prefill`` fills the caches through the non-kernel branch and
    ``decode_step`` continues from them; the last prefill logits equal the
    forward's at that position, and each decode step's logits equal the
    forward's over the longer prompt (tol 1e-4: the same route, one batch
    of queries against chunks of another length)."""
    _, pcfg, _, pparams, tokens = _tiny(mma)
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        full, _ = models.forward(pparams, pcfg, toks)
        caches = models.make_caches(pcfg, 2, 24, "cpu")
        last, caches = models.prefill(pparams, pcfg, toks[:, :20], caches)
        np.testing.assert_allclose(last[:, 0].numpy(), full[:, 19].numpy(), rtol=0, atol=1e-4)
        for pos in range(20, 23):
            step, caches = models.decode_step(pparams, pcfg, toks[:, pos:pos + 1], caches, pos)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, pos].numpy(), rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("mma", MMA, ids=MMA_IDS)
def test_tiny_olmo_loss_gradient_matches_reference(mma):
    """A training step's gradients on this route: the chunked loss of the
    port's ``make_grads_fn`` against ``jax.grad`` of the reference's loss
    (the same function: forward_hidden, then lm_loss_chunked), at the
    tolerances above."""
    from repro.models.losses import lm_loss_chunked as ref_lm_loss_chunked
    from repro.models.model import forward_hidden as ref_forward_hidden
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.steps import make_grads_fn

    rcfg, pcfg, rparams, pparams, tokens = _tiny(mma)

    def ref_loss(params):
        h, aux = ref_forward_hidden(params, rcfg, jnp.asarray(tokens[:, :-1]))
        loss, _ = ref_lm_loss_chunked(params, rcfg, h, jnp.asarray(tokens[:, 1:]), aux)
        return loss

    rl, rg = jax.value_and_grad(ref_loss)(rparams)
    for p in R.tree_leaves(pparams):
        p.requires_grad_(True)
    grads, loss = make_grads_fn(pcfg, TrainConfig())(pparams, {"tokens": torch.from_numpy(tokens)})
    want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rg), pcfg))
    assert abs(float(loss) - float(rl)) <= 1e-4
    for w, g in zip(want, grads):
        assert float((g - w).abs().max()) <= 2**-6 * float(w.abs().max()) + 1e-6
