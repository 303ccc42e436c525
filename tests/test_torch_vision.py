"""Port parity of vision cross-attention (``models.attention``'s
``cross_attention_init`` / ``cross_attention_apply`` / the xattn cache and
decode, ``models.frontends``) and of llama-3.2-vision-11b, against the
reference from the same weights and the same context.

The tanh gate is zero at init: a random-weight model's cross-attention
adds exactly nothing. So every parity check here first sets the gates to
0.5 in both packages, and keeps a planted fault -- the keys and values
taken from the NORMED context (the prefill must read ctx as given) --
that must fail its limit.

  * ``cross_attention_apply`` with the gate at 0.5 against the reference,
    with the gradients to q, k, v, o, the gate, x and ctx; at gate 0 the
    output is exactly zero;
  * the xattn block's prefill (its cache: the un-normed context's keys and
    values) and decode against the reference's ``block_fill_cache`` /
    ``block_decode``;
  * ``synth_image_embeds``: shape, dtype, the same values from the same
    seed on every call;
  * tiny llama-3.2-vision (5 layers: 4 attn + 1 xattn, 16 image tokens):
    the config field by field, the counts (the 0-d gate in
    ``stored_param_count``, 10 leaves an xattn block, the serving bytes
    with the context), the reference's tree carried across (the gate 0-d),
    prefill then multi-step decode against the reference's engine and the
    port's own forward, the planted fault failing that limit, two train
    steps against the reference's with the fused second moment (the gate a
    group of its own), the 0-d gate through the clip statistic and a
    checkpoint round trip, a retried decode step bitwise, and the training
    CLI refusing full depth.

Tolerances: the block 1e-5 at ~1 (f32; the chunked attention rounds q, k,
v and p to bf16 on both sides), gradients 1e-3 of each one's largest
element (a bf16 rounding of p may flip); the logits 6e-3 against the
reference (its ``tests/test_serving_consistency.py`` envelope; observed
~5e-6) and 6e-3 + 1e-3 relative against the port's forward; the train
steps as ``tests/test_torch_dense_archs.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro import reduce as RR
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_arch as ref_arch
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.serve import GuardedEngine as RefEngine
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import attention as RA
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import attention as A
from repro_torch.models import forward, init_params
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, reference_leaf_groups, tensor_from_numpy
from repro_torch.models.frontends import synth_image_embeds
from repro_torch.models.model import stored_param_count
from repro_torch.models.params import count_params
from test_torch_rglru import assert_config_is_the_reference, refuses_full_depth

ARCH = "llama-3.2-vision-11b"
SLOTS, PROMPT, NEW = 2, 8, 4
S_MAX = PROMPT + NEW + 1
GATE = 0.5
LOGIT_ATOL = 6e-3
SELF_ATOL, SELF_RTOL = 6e-3, 1e-3


def _rng(seed=0):
    return np.random.default_rng(seed)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _gates_at(tree, value):
    """The reference's tree with every cross-attention gate set to
    ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, value) if path[-1].key == "gate" else x, tree)


def _normed_ctx_kv(p, ctx, cfg):
    """A planted fault: the context's keys and values from its RMSNorm."""
    normed = L.norm_apply("rmsnorm", {"scale": torch.ones(ctx.shape[-1], dtype=ctx.dtype)},
                          ctx, eps=cfg.norm_eps, mma=False)
    return REAL_CROSS_KV(p, normed, cfg)


REAL_CROSS_KV = A.cross_kv


def _xattn(seed=0):
    rcfg, pcfg = ref_arch(ARCH, tiny=True), get_arch(ARCH, tiny=True)
    rp, _ = RA.cross_attention_init(jax.random.PRNGKey(seed), rcfg.d_model, rcfg.n_heads,
                                    rcfg.n_kv_heads, rcfg.d_head, jnp.float32)
    assert rp["gate"].shape == () and float(rp["gate"]) == 0.0
    rp = dict(rp, gate=jnp.asarray(GATE, jnp.float32))
    return rcfg, pcfg, rp, _torch_tree(rp)


def test_cross_attention_matches_reference_with_gradients_and_a_planted_fault(monkeypatch):
    rcfg, pcfg, rp, pp = _xattn(1)
    x = _rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    ctx = _rng(2).standard_normal((2, 16, 64)).astype(np.float32)
    w = _rng(3).standard_normal((2, 7, 64)).astype(np.float32)

    def ref_loss(p, xx, cc):
        return jnp.sum(RA.cross_attention_apply(p, xx, cc, rcfg) * w)

    want = np.asarray(RA.cross_attention_apply(rp, jnp.asarray(x), jnp.asarray(ctx), rcfg))
    rgp, rgx, rgc = jax.grad(ref_loss, argnums=(0, 1, 2))(rp, jnp.asarray(x), jnp.asarray(ctx))
    leaves = {k: (v["w"] if isinstance(v, dict) else v) for k, v in pp.items()}
    for t in leaves.values():
        t.requires_grad_(True)
    xt, ct = (torch.from_numpy(a).requires_grad_(True) for a in (x, ctx))
    got = A.cross_attention_apply(pp, xt, ct, pcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    grads = {k: (v["w"] if isinstance(v, dict) else v) for k, v in rgp.items()}
    for name, t in list(leaves.items()) + [("x", xt), ("ctx", ct)]:
        ref = np.asarray({"x": rgx, "ctx": rgc}.get(name, grads.get(name)))
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-3 * float(np.abs(ref).max()), err_msg=name)
    with torch.no_grad():
        shut = A.cross_attention_apply(dict(pp, gate=torch.zeros(())), xt, ct, pcfg)
        assert torch.equal(shut, torch.zeros_like(shut))  # tanh(0) = 0: nothing added
        monkeypatch.setattr(A, "cross_kv", _normed_ctx_kv)
        wrong = A.cross_attention_apply(pp, xt, ct, pcfg)
    assert float(np.abs(wrong.numpy() - want).max()) > 1e-5


def test_xattn_cache_and_decode_match_reference():
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    rp, _ = RM.block_init("xattn", jax.random.PRNGKey(3), rcfg)
    rp = _gates_at(rp, GATE)
    pp = _torch_tree(rp)
    h = _rng(4).standard_normal((2, 6, 64)).astype(np.float32)
    ht = _rng(5).standard_normal((2, 1, 64)).astype(np.float32)
    ctx = _rng(6).standard_normal((2, 16, 64)).astype(np.float32)
    positions = jnp.broadcast_to(jnp.arange(6), (2, 6))
    rcache = RM.block_make_cache("xattn", 2, 16, rcfg)
    rh, _, rcache = RM.block_fill_cache("xattn", rp, jnp.asarray(h), positions, rcache, rcfg,
                                        jnp.asarray(ctx))
    rdh, _ = RM.block_decode("xattn", rp, jnp.asarray(ht), rcache, jnp.asarray(6, jnp.int32),
                             rcfg, jnp.asarray(ctx))
    cache = M.block_make_cache("xattn", 2, 16, pcfg, "cpu")
    assert cache["k"].shape == (2, 16, 2, 16)
    with torch.no_grad():
        ph, cache = M.block_fill_cache("xattn", pp, torch.from_numpy(h),
                                       torch.from_numpy(np.array(positions)), cache, pcfg,
                                       torch.from_numpy(ctx))
        kept = {k: v.clone() for k, v in cache.items()}
        pdh, cache2 = M.block_decode("xattn", pp, torch.from_numpy(ht), cache, 6, pcfg)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]), rtol=0,
                                   atol=4e-6)
        assert torch.equal(cache2[key], kept[key])  # the decode only reads it
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pdh.numpy(), np.asarray(rdh), rtol=0, atol=1e-5)


def test_synth_image_embeds_shape_dtype_and_seed():
    a = synth_image_embeds(torch.Generator().manual_seed(1), 3, 1032, 32, torch.bfloat16)
    b = synth_image_embeds(torch.Generator().manual_seed(1), 3, 1032, 32, torch.bfloat16)
    c = synth_image_embeds(torch.Generator().manual_seed(2), 3, 1032, 32)
    assert a.shape == (3, 1032, 32) and a.dtype == torch.bfloat16 and a.device.type == "cpu"
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().std()) - 1.0) < 0.05


# -------------------------- llama-3.2-vision-11b ---------------------------


def test_config_counts_and_shapes_are_the_reference():
    assert_config_is_the_reference(ARCH)
    full = get_arch(ARCH)
    assert full.pattern_layers.count("xattn") == 8 and not full.subquadratic
    assert full.rope_theta == 500000.0 and full.n_img_tokens == 1032


def test_stored_counts_leaves_and_serving_bytes():
    cfg = get_arch(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(ARCH, tiny=True))
    assert count_params(params) == stored_param_count(cfg) == \
        sum(x.size for x in jax.tree.leaves(rparams))
    assert stored_param_count(cfg) - cfg.param_count() == 5 * 2 * 64 + 64 + 1  # norms, gate
    assert train_cli.param_leaves(cfg) == len(R.tree_leaves(params))
    xattn = params["layers"][4]
    assert len(R.tree_leaves(xattn)) == 10
    assert xattn["mix"]["gate"].shape == () and float(xattn["mix"]["gate"]) == 0.0
    eng = GuardedEngine(cfg, S_MAX, SLOTS, device="cpu", params=params)
    assert eng.ctx.shape == (SLOTS, 16, 64) and eng.ctx.dtype == torch.float32
    caches = eng._prefill(eng.params, torch.zeros((SLOTS, 4), dtype=torch.int64))[1]
    assert caches["layers"][4]["k"].shape == (SLOTS, 16, 2, 16)
    held = sum(t.numel() * t.element_size()
               for t in R.tree_leaves(eng.params) + R.tree_leaves(caches) + [eng.ctx])
    assert serve_cli.serve_state_bytes(cfg, SLOTS, S_MAX) == held
    full = get_arch(ARCH)
    assert train_cli.param_leaves(full) == 8 * (4 * 9 + 10) + 3
    assert 19.8e9 < serve_cli.serve_state_bytes(full, 4, 273) < 19.9e9


def _engines():
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=0)
    reng.params = _gates_at(reng.params, GATE)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    peng = GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)
    peng.ctx = tensor_from_numpy(np.asarray(reng.ctx))
    return reng, peng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _prefill_and_decode(reng, peng, tokens):
    """The port's prefill and decode logits against the reference's and its
    own forward: the largest |d| from each."""
    ctx = reng.ctx
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(tokens[:, :PROMPT], jnp.int32),
                                     ctx)
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(tokens[:, :PROMPT]))
        full, _ = forward(peng.params, peng.cfg, torch.from_numpy(tokens), peng.ctx)
    ref_err = float(np.abs(got.numpy() - np.asarray(want)).max())
    self_err = float(((got - full[:, PROMPT - 1:PROMPT]).abs()
                      - SELF_RTOL * full[:, PROMPT - 1:PROMPT].abs()).max())
    rdec = jax.jit(ref_decode_step(reng.cfg, greedy=False))
    for t in range(NEW - 1):
        pos = PROMPT + t
        tok = tokens[:, pos:pos + 1]
        want, rcache = rdec(reng.params, rcache, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32), ctx)
        with torch.inference_mode():
            got, pcache = peng._decode_logits(peng.params, pcache, torch.from_numpy(tok), pos)
        ref_err = max(ref_err, float(np.abs(got.numpy() - np.asarray(want)).max()))
        self_err = max(self_err, float(((got - full[:, pos:pos + 1]).abs()
                                        - SELF_RTOL * full[:, pos:pos + 1].abs()).max()))
    return ref_err, self_err


def test_prefill_then_decode_match_reference_and_forward(engines, monkeypatch):
    reng, peng = engines
    tokens = _rng(0).integers(0, 256, size=(SLOTS, PROMPT + NEW))
    ref_err, self_err = _prefill_and_decode(reng, peng, tokens)
    assert ref_err <= LOGIT_ATOL and self_err <= SELF_ATOL
    monkeypatch.setattr(A, "cross_kv", _normed_ctx_kv)
    assert _prefill_and_decode(reng, peng, tokens)[0] > LOGIT_ATOL


def test_decode_step_issued_twice_is_bitwise(engines):
    _, peng = engines
    prompts = [_rng(7 + i).integers(0, 256, size=(PROMPT,)) for i in range(SLOTS)]
    state, _, _ = peng.start_wave(prompts, [1.0] * SLOTS, "cuda_fused")
    s1, tok1, cen1 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    _, _, bad = peng.decode(state, [float("nan")] + [1.0] * (SLOTS - 1), "cuda_fused")
    s2, tok2, cen2 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    assert bad[0] > 0
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_array_equal(cen1, cen2)
    for a, b in zip(R.tree_leaves(s1["caches"]), R.tree_leaves(s2["caches"])):
        assert torch.equal(a, b)


@pytest.fixture
def kernel_backends():
    RR.set_default_backend("pallas_fused")
    R.set_default_backend("cuda_fused")
    yield
    RR.set_default_backend(None)
    R.set_default_backend(None)


def test_tiny_train_steps_match_reference_with_the_fused_second_moment(kernel_backends):
    steps = 2
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    kw = dict(total_steps=steps, warmup_steps=1, fused_second_moment=True)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    rparams = _gates_at(rparams, GATE)
    ropt = RO.init_state(rparams, fused_second_moment=True)
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(**kw)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    groups = reference_leaf_groups(pparams, pcfg)
    assert len(set(groups)) == len(jax.tree.leaves(rparams))
    pparams, popt, pstep = train_cli.build(pcfg, TrainConfig(**kw), "cpu", params=pparams)
    data = RefSyntheticLM(pcfg.vocab_size, 16, 2, seed=0)
    ctx = _rng(8).standard_normal((2, 16, 64)).astype(np.float32)
    lr = TrainConfig().learning_rate
    for step in range(1, steps + 1):
        tokens = data.next()["tokens"]
        rparams, ropt, rm = rstep(rparams, ropt, {"tokens": jnp.asarray(tokens),
                                                  "image_embeds": jnp.asarray(ctx)})
        pparams, popt, pm = pstep(pparams, popt, {"tokens": torch.from_numpy(tokens),
                                                  "image_embeds": torch.from_numpy(ctx)})
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3
        for key in ("grad_norm", "clip", "lr"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=1e-4), key
        want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rparams), pcfg))
        got = [p.detach() for p in R.tree_leaves(pparams)]
        diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, got)])
        assert float(diffs.max()) <= 2 * lr * step
        assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()
    gate = pparams["layers"][4]["mix"]["gate"].detach()
    assert gate.shape == () and float(gate) != GATE  # the gate trains


def test_zero_d_gate_through_the_clip_statistic_and_a_checkpoint(tmp_path):
    cfg = get_arch(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["layers"][4]["mix"]["gate"].fill_(GATE)
    leaves = R.tree_leaves(params)
    assert sum(t is params["layers"][4]["mix"]["gate"] for t in leaves) == 1
    gnorm, clip, counts = optim.global_norm_and_clip(params, 1.0, backend="cuda_fused",
                                                     census=True)
    exact = float(sum(float(t.double().square().sum()) for t in leaves)) ** 0.5
    assert float(gnorm) == pytest.approx(exact, rel=1e-5)
    assert float(counts[-1]) == 0.0
    poisoned = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    poisoned["layers"][4]["mix"]["gate"].fill_(float("nan"))
    _, _, counts = optim.global_norm_and_clip(poisoned, 1.0, backend="cuda_fused", census=True)
    assert float(counts[-1]) == 1.0  # the one-element part is counted
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, params, blocking=True)
    like = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    restored = ckpt.restore(1, like)
    gate = restored["layers"][4]["mix"]["gate"]
    assert gate.shape == () and float(gate) == GATE
    assert all(torch.equal(a, b) for a, b in zip(R.tree_leaves(restored), leaves))


def test_train_cli_refuses_full_depth_before_allocating(monkeypatch):
    assert 195e9 < train_cli.train_state_bytes(get_arch(ARCH), TrainConfig()) < 196e9
    refuses_full_depth(monkeypatch, ARCH, 10, 95, (38.7, 38.9))
