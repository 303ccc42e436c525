"""Port parity of Multi-head Latent Attention (``repro_torch.models.mla``)
and of minicpm3-4b, against ``repro.models.mla`` and the reference's
engine from the same weights, carried across.

  * ``layers.rmsnorm_apply_many`` against the reference's and against the
    single norms it batches;
  * ``mla_train``, ``mla_fill_cache`` and ``mla_decode`` (the weight-
    absorbed step) with the paper's technique on and off, and
    ``mla_train``'s gradients to its input and its weights against
    ``jax.grad``;
  * tiny minicpm3: ``param_count`` and the stored tensors, the training
    CLI's leaf count, the serving state's bytes against a built engine,
    prefill then multi-step decode against the reference's engine
    (``use_pallas=True``, Pallas kernels in interpret mode) and against
    the port's own teacher-forcing forward, and two train steps against
    the reference's.

Tolerances (tiny minicpm3 is f32; every side rounds attention's q, k, v
and p, and the MMA norms' squares, to bf16 at the same points):
  * the block functions 1e-4 absolute at outputs of ~3 (observed 1.2e-7
    with the technique on, 2.8e-5 off: an f32 sum in another order moves
    one bf16 rounding of a p), gradients 2e-3 of each leaf's largest
    element (observed 4e-4 off, 5e-7 on), the latent cache 1e-5
    (observed 2.4e-7: f32 products), the slot positions exactly;
    ``rmsnorm_apply_many`` 1e-6 against the reference and against the
    single norms (f32 sums of the same bf16 squares; zero padding is
    exact);
  * logits against the reference's engine 0.01, the limit of the MoE
    archs (``tests/test_torch_dense_archs.py``), over 4 prompt seeds
    (observed up to 4.5e-3 on 2 of them, 2e-6 on the others: the flips
    above, carried through 3 layers);
  * decode against the port's own forward 4e-2 + 1e-3 relative, the
    reference's envelope for the weight-absorbed decode
    (``tests/test_serving_consistency.py``): the same algebra with the
    bf16 roundings in the latent space instead of per head;
  * the train steps: loss 1e-3, grad norm and clip 1e-3 relative,
    parameters within 2 lr x steps with all but 0.1% within 1e-5, the
    tolerances of ``tests/test_torch_dense_archs.py`` with the relative
    ones widened from 1e-4 for the flips above.
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
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import mla as RMLA
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import forward, init_params
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.params import count_params

ARCH = "minicpm3-4b"
SLOTS, PROMPT, NEW, S_MAX = 2, 20, 6, 32
LOGIT_ATOL = 0.01
SELF_ATOL, SELF_RTOL = 4e-2, 1e-3


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _cfgs(mma=True):
    return (dataclasses.replace(ref_arch(ARCH, tiny=True), mma_reductions=mma),
            dataclasses.replace(get_arch(ARCH, tiny=True), mma_reductions=mma))


def _block(seed, mma):
    rcfg, pcfg = _cfgs(mma)
    rp, _ = RMLA.mla_init(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, PROMPT, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PROMPT), (2, PROMPT)).copy()
    return rcfg, pcfg, rp, _torch_tree(rp), x, pos, rng


@pytest.mark.parametrize("mma", [True, False], ids=["mma", "plain"])
def test_rmsnorm_apply_many_matches_reference_and_single_norms(mma):
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, 7, 32)).astype(np.float32),
          (rng.standard_normal((3, 7, 16)) * 3).astype(np.float32)]
    scales = [rng.uniform(0.5, 1.5, x.shape[-1]).astype(np.float32) for x in xs]
    want = RL.rmsnorm_apply_many([{"scale": jnp.asarray(s)} for s in scales],
                                 [jnp.asarray(x) for x in xs], eps=1e-5, mma=mma)
    ps = [{"scale": torch.from_numpy(s)} for s in scales]
    got = L.rmsnorm_apply_many(ps, [torch.from_numpy(x) for x in xs], eps=1e-5, mma=mma)
    for g, w, p, x in zip(got, want, ps, xs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        single = L.norm_apply("rmsnorm", p, torch.from_numpy(x), eps=1e-5, mma=mma)
        torch.testing.assert_close(g, single, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mma", [True, False], ids=["mma", "plain"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mla_train_fill_and_decode_match_reference(seed, mma):
    rcfg, pcfg, rp, pp, x, pos, rng = _block(seed, mma)
    want = np.asarray(RMLA.mla_train(rp, jnp.asarray(x), jnp.asarray(pos), rcfg))
    with torch.no_grad():
        got = M.mla_train(pp, torch.from_numpy(x), torch.from_numpy(pos), pcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    rcache = RMLA.mla_fill_cache(rp, jnp.asarray(x), jnp.asarray(pos),
                                 RMLA.make_mla_cache(2, S_MAX, rcfg), rcfg)
    pcache = M.make_mla_cache(2, S_MAX, pcfg, torch.float32, "cpu")
    with torch.no_grad():
        out = M.mla_fill_cache(pp, torch.from_numpy(x), torch.from_numpy(pos), pcache, pcfg)
    assert out is pcache  # filled in place
    np.testing.assert_allclose(pcache["ckv"].numpy(), np.asarray(rcache["ckv"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(pcache["slot_pos"].numpy(), np.asarray(rcache["slot_pos"]))
    for t in range(2):
        xt = rng.standard_normal((2, 1, pcfg.d_model)).astype(np.float32)
        wo, rcache = RMLA.mla_decode(rp, jnp.asarray(xt), rcache,
                                     jnp.asarray(PROMPT + t, jnp.int32), rcfg)
        with torch.no_grad():
            go, pcache = M.mla_decode(pp, torch.from_numpy(xt), pcache, PROMPT + t, pcfg)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=0, atol=1e-4)
        np.testing.assert_allclose(pcache["ckv"].numpy(), np.asarray(rcache["ckv"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(pcache["slot_pos"].numpy(),
                                      np.asarray(rcache["slot_pos"]))


@pytest.mark.parametrize("mma", [True, False], ids=["mma", "plain"])
def test_mla_train_gradients_match_jax(mma):
    rcfg, pcfg, rp, pp, x, pos, rng = _block(3, mma)
    w = rng.standard_normal((2, PROMPT, pcfg.d_model)).astype(np.float32)

    def ref_loss(p, xx):
        return jnp.sum(RMLA.mla_train(p, xx, jnp.asarray(pos), rcfg) * w)

    rgp, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: {kk: vv.requires_grad_(True) for kk, vv in v.items()} for k, v in pp.items()}
    (M.mla_train(leaves, xt, torch.from_numpy(pos), pcfg) * torch.from_numpy(w)).sum().backward()
    pairs = [(xt.grad, rgx)] + [(leaves[k][kk].grad, rgp[k][kk]) for k in pp for kk in pp[k]]
    assert len(pairs) == 8  # x and the seven leaves
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-3 * float(np.abs(want).max()))


def test_counts_leaves_and_serving_bytes():
    for tiny in (False, True):
        assert get_arch(ARCH, tiny).param_count() == ref_arch(ARCH, tiny).param_count()
    cfg = get_arch(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(ARCH, tiny=True))
    assert count_params(params) == sum(x.size for x in jax.tree.leaves(rparams))
    assert train_cli.param_leaves(cfg) == len(R.tree_leaves(params))
    assert set(params["layers"][0]["mix"]) == {"q_down", "q_up", "kv_down", "kv_up", "o",
                                               "q_norm", "kv_norm"}
    # the serving state: the parameters and every layer's latent cache
    # (kv_lora + rope values a token) with its slot positions
    eng = GuardedEngine(cfg, S_MAX, SLOTS, device="cpu", params=params)
    caches = eng._prefill(eng.params, torch.zeros((SLOTS, 4), dtype=torch.int64))[1]
    assert caches["layers"][0]["ckv"].shape == (SLOTS, S_MAX, 16 + 8)
    held = sum(t.numel() * t.element_size()
               for t in R.tree_leaves(params) + R.tree_leaves(caches))
    assert serve_cli.serve_state_bytes(cfg, SLOTS, S_MAX) == held
    # full width: 62 layers of 12 leaves, the embedding, final norm and head
    full = get_arch(ARCH)
    assert train_cli.param_leaves(full) == 62 * 12 + 3
    assert 8.5e9 < serve_cli.serve_state_bytes(full, 4, 273) < 8.6e9


def _engines():
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    return reng, GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefill_then_decode_match_reference_and_forward(engines, seed):
    reng, peng = engines
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(SLOTS, PROMPT + NEW))
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(tokens[:, :PROMPT], jnp.int32))
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(tokens[:, :PROMPT]))
        full, _ = forward(peng.params, peng.cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), full[:, PROMPT - 1:PROMPT].numpy(),
                               rtol=SELF_RTOL, atol=SELF_ATOL)
    rdec = jax.jit(ref_decode_step(reng.cfg, greedy=False))
    for t in range(NEW - 1):
        pos = PROMPT + t
        tok = tokens[:, pos:pos + 1]
        want, rcache = rdec(reng.params, rcache, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            got, pcache = peng._decode_logits(peng.params, pcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(got.numpy(), full[:, pos:pos + 1].numpy(),
                                   rtol=SELF_RTOL, atol=SELF_ATOL)


def test_retried_decode_step_is_bitwise_the_clean_step(engines):
    _, peng = engines
    prompts = [np.random.default_rng(7 + i).integers(0, 256, size=(PROMPT,)) for i in
               range(SLOTS)]
    state, _, _ = peng.start_wave(prompts, [1.0] * SLOTS, "cuda_fused")
    s1, tok1, cen1 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    snap = [c["ckv"].clone() for c in s1["caches"]["layers"]]
    s2, tok2, cen2 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_array_equal(cen1, cen2)
    for a, c in zip(snap, s2["caches"]["layers"]):
        assert torch.equal(a, c["ckv"])


@pytest.fixture
def kernel_backends():
    RR.set_default_backend("pallas_fused")
    R.set_default_backend("cuda_fused")
    yield
    RR.set_default_backend(None)
    R.set_default_backend(None)


def test_tiny_train_steps_match_reference(kernel_backends):
    steps = 2
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    kw = dict(total_steps=steps, warmup_steps=1)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ropt = RO.init_state(rparams)
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(**kw)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    pparams, popt, pstep = train_cli.build(pcfg, TrainConfig(**kw), "cpu", params=pparams)
    data = RefSyntheticLM(pcfg.vocab_size, 16, 2, seed=0)
    lr = TrainConfig().learning_rate
    losses = []
    for step in range(1, steps + 1):
        tokens = data.next()["tokens"]
        rparams, ropt, rm = rstep(rparams, ropt, {"tokens": jnp.asarray(tokens)})
        pparams, popt, pm = pstep(pparams, popt, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3
        for key in ("grad_norm", "clip", "lr"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=1e-3), key
        want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rparams), pcfg))
        got = [p.detach() for p in R.tree_leaves(pparams)]
        diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, got)])
        assert float(diffs.max()) <= 2 * lr * step
        assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()
        losses.append(float(pm["loss"]))
    assert all(np.isfinite(losses))


def test_train_cli_refuses_full_depth_before_allocating(monkeypatch):
    """minicpm3-4b's full-depth state (85.2 GB) sits within 0.2% of an 80
    GB card's memory: the CLI refuses it with the activation reserve, so
    the answer does not hang on rounding; what the card runs still runs."""
    tcfg = TrainConfig()
    full = get_arch(ARCH)
    assert 85.2e9 < train_cli.train_state_bytes(full, tcfg) < 85.3e9
    cut = dataclasses.replace(full, n_layers=16)
    assert train_cli.param_leaves(cut) == 195
    assert 27.5e9 < train_cli.train_state_bytes(cut, tcfg) < 27.7e9

    class Props:
        total_memory = 85_045_395_456  # an H100 80GB HBM3

    def no_alloc(*args, **kwargs):
        raise AssertionError("the CLI allocated parameters before its size check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(train_cli, "init_params", no_alloc)
    cuda = torch.device("cuda")
    for name in (ARCH, "deepseek-7b"):
        with pytest.raises(ValueError, match="sharded over more cards"):
            train_cli.check_fits_card(get_arch(name), tcfg, cuda)
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", ARCH, "--steps", "1"])
    for cfg in (cut, get_arch("mamba2-780m"), get_arch("olmo-1b"), get_arch("internlm2-1.8b"),
                get_arch("granite-moe-1b-a400m")):
        train_cli.check_fits_card(cfg, tcfg, cuda)
    train_cli.check_fits_card(full, tcfg, torch.device("cpu"))
