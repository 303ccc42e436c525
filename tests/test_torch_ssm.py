"""Port parity of the Mamba-2 block (``repro_torch.models.ssm``) and of
mamba2-780m, against ``repro.models.ssm`` and the reference's engine from
the same weights, carried across.

  * ``layers.causal_conv1d`` and ``conv1d_step`` (the decode steps replay
    the conv);
  * ``ssd_chunked`` at a length off the chunk multiples, on ``torch`` and
    ``mma_torch`` against the reference's ``xla`` and ``mma_jnp``: the
    output, the final state and the gradients to x, dt, A, B and C (the
    first model path that differentiates the decay scans);
  * the ``ssm_train(return_state=True)`` -> ``ssm_decode`` handoff, and
    both against the reference's;
  * tiny mamba2: the counts (parameters, leaves, the f32 leaves, the
    serving bytes against a built engine), prefill then decode against the
    reference's engine and the port's own forward over 4 prompt seeds, a
    train step that lowers the loss and two against the reference's, a
    decode step issued twice from one state (bitwise equal, the state
    untouched), and a chaos run of the guarded runtime bitwise the clean
    run.

Tolerances (tiny mamba2 is f32; the SSM path has no bf16 rounding but the
MMA norms' squares):
  * the conv 1e-6 (f32 multiply-adds in another order), the decode steps
    against ``causal_conv1d`` exactly (the same adds in the same order);
  * ``ssd_chunked`` 1e-5 of the output's largest element and the final
    state 1e-5 of its own (observed 1.4e-7: f32 products of other
    orders), gradients 1e-4 of each one's largest element;
  * the block 1e-4 absolute at ~3, the handoff (decode against the train
    path on one more token) 1e-5;
  * the logits against the reference 1e-3 at ~3 over 4 prompt seeds
    (observed 1.6e-5 at the prefill and the first steps, up to 2.4e-4 by
    the fifth decode step on 2 seeds: inputs 1e-6 apart, f32 sums of
    other orders, flip a bf16 rounding of the gated norm's squares, and
    the recurrent state carries it on);
  * the decoded logits against the port's own forward 6e-3 + 1e-3
    relative, the reference's envelope for every cache but MLA's
    (``tests/test_serving_consistency.py``; observed up to 2.4e-4: the
    recurrent step and the chunked SSD sum in other orders, and inputs
    1e-6 apart can flip a bf16 rounding of the gated norm's squares);
  * the train steps: loss 1e-3, grad norm and clip 1e-4 relative,
    parameters within 2 lr x steps with all but 0.1% within 1e-5 (the
    tolerances of ``tests/test_torch_dense_archs.py``).
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
from repro.models import ssm as RSSM
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import forward, init_params
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.model import f32_param_count
from repro_torch.models.params import count_params
from repro_torch.runtime import ChaosMonkey, Request, ServingRuntime

ARCH = "mamba2-780m"
SLOTS, PROMPT, NEW, S_MAX = 2, 20, 6, 32
ATOL = 1e-4
LOGIT_ATOL = 1e-3
SELF_ATOL, SELF_RTOL = 6e-3, 1e-3


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_causal_conv1d_and_steps_match_reference():
    rng = _rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    want = np.asarray(RL.causal_conv1d(jnp.asarray(x), jnp.asarray(w)))
    got = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the decode steps from a zero window replay the conv, bitwise
    state = torch.zeros((2, 3, 24))
    rstate = jnp.zeros((2, 3, 24))
    for t in range(x.shape[1]):
        before = state.clone()
        new, y = L.conv1d_step(state, torch.from_numpy(x[:, t]), torch.from_numpy(w))
        assert torch.equal(state, before)  # the window given is not written
        assert torch.equal(y, got[:, t])
        rstate, ry = RL.conv1d_step(rstate, jnp.asarray(x[:, t]), jnp.asarray(w))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(rstate))
        state = new


def _ssd_inputs(seed, l=40, g=1):
    rng = _rng(seed)
    b, h, p, n = 2, 4, 8, 16
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            (np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(np.float32),
            -np.exp(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32))


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("mma_torch", "mma_jnp")])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference_with_gradients(backend, ref_backend, g):
    ins = _ssd_inputs(2, l=40, g=g)  # 40 = 2 chunks of 16 + 8
    w = _rng(3).standard_normal(ins[0].shape).astype(np.float32)
    ws = _rng(4).standard_normal((2, 4, 8, 16)).astype(np.float32)

    def ref_loss(*a):
        y, f = RSSM.ssd_chunked(*a, 16, backend=ref_backend)
        return jnp.sum(y * w) + jnp.sum(f * ws), (y, f)

    rgrads, (ry, rf) = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in ins))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, f = S.ssd_chunked(*ts, 16, backend=backend)
    assert y.shape == ins[0].shape and f.shape == (2, 4, 8, 16) and f.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(ry)).max()))
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(rf), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(rf)).max()))
    ((y * torch.from_numpy(w)).sum() + (f * torch.from_numpy(ws)).sum()).backward()
    for t, rg in zip(ts, rgrads):
        rg = np.asarray(rg)
        np.testing.assert_allclose(t.grad.numpy(), rg, rtol=0,
                                   atol=1e-4 * float(np.abs(rg).max()))


def _block(seed=0, mma=True):
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), mma_reductions=mma)
    pcfg = dataclasses.replace(get_arch(ARCH, tiny=True), mma_reductions=mma)
    rp, _ = RSSM.ssm_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, rp, _torch_tree(rp)


@pytest.mark.parametrize("mma", [True, False], ids=["mma", "plain"])
def test_train_to_decode_handoff_matches_reference(mma):
    rcfg, pcfg, rp, pp = _block(1, mma)
    assert all(pp[k].dtype == torch.float32 for k in ("dt_bias", "A_log", "D"))
    rng = _rng(5)
    x = rng.standard_normal((2, PROMPT + 3, pcfg.d_model)).astype(np.float32)
    # l = 23: the prompt is not a multiple of the chunk (16)
    with torch.no_grad():
        full = S.ssm_train(pp, torch.from_numpy(x), pcfg)
        out, cache = S.ssm_train(pp, torch.from_numpy(x[:, :PROMPT]), pcfg, return_state=True)
    rout, rcache = RSSM.ssm_train(rp, jnp.asarray(x[:, :PROMPT]), rcfg, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=0, atol=ATOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(out.numpy(), full[:, :PROMPT].numpy(), rtol=0, atol=1e-5)
    for t in range(3):
        xt = x[:, PROMPT + t:PROMPT + t + 1]
        with torch.no_grad():
            yt, cache = S.ssm_decode(pp, torch.from_numpy(xt), cache, pcfg)
        ryt, rcache = RSSM.ssm_decode(rp, jnp.asarray(xt), rcache, rcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(ryt), rtol=0, atol=ATOL)
        np.testing.assert_allclose(yt.numpy(), full[:, PROMPT + t:PROMPT + t + 1].numpy(),
                                   rtol=0, atol=1e-5)


def test_short_prompt_conv_window_is_front_padded():
    _, pcfg, _, pp = _block(2)
    x = torch.from_numpy(_rng(6).standard_normal((1, 2, pcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, cache = S.ssm_train(pp, x, pcfg, return_state=True)
    assert cache["conv"].shape == (1, 3, S._dims(pcfg)[3])
    assert torch.equal(cache["conv"][:, 0], torch.zeros_like(cache["conv"][:, 0]))


def test_counts_leaves_and_serving_bytes():
    for tiny in (False, True):
        assert get_arch(ARCH, tiny).param_count() == ref_arch(ARCH, tiny).param_count()
        assert get_arch(ARCH, tiny).subquadratic and get_arch(ARCH, tiny).attention_free
    cfg = get_arch(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(ARCH, tiny=True))
    assert count_params(params) == sum(x.size for x in jax.tree.leaves(rparams))
    leaves = R.tree_leaves(params)
    assert train_cli.param_leaves(cfg) == len(leaves)
    layer = params["layers"][0]
    assert set(layer) == {"norm1", "mix"}  # no FFN
    f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    bf_params = init_params(bf, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in R.tree_leaves(bf_params)
               if t.dtype == torch.float32) == f32_param_count(bf) == 4 * 3 * 8
    assert f32 == count_params(params)  # the tiny config is f32 throughout
    for c in (cfg, bf):
        eng = GuardedEngine(c, S_MAX, SLOTS, device="cpu",
                            params=init_params(c, torch.Generator().manual_seed(0), "cpu"))
        caches = eng._prefill(eng.params, torch.zeros((SLOTS, 4), dtype=torch.int64))[1]
        assert caches["layers"][0]["state"].dtype == torch.float32
        held = sum(t.numel() * t.element_size()
                   for t in R.tree_leaves(eng.params) + R.tree_leaves(caches))
        assert serve_cli.serve_state_bytes(c, SLOTS, S_MAX) == held
    # full width: 48 blocks of 10 leaves, the embedding and the final norm
    full = get_arch(ARCH)
    assert train_cli.param_leaves(full) == 482
    assert 15.5e9 < train_cli.train_state_bytes(full, TrainConfig()) < 15.7e9
    assert 1.8e9 < serve_cli.serve_state_bytes(full, 4, 273) < 1.9e9


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
    tokens = _rng(seed).integers(0, 256, size=(SLOTS, PROMPT + NEW))
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


def test_decode_step_issued_twice_is_bitwise_and_leaves_the_state(engines):
    _, peng = engines
    prompts = [_rng(7 + i).integers(0, 256, size=(PROMPT,)) for i in range(SLOTS)]
    state, _, _ = peng.start_wave(prompts, [1.0] * SLOTS, "cuda_fused")
    committed = [{k: v.clone() for k, v in c.items()} for c in state["caches"]["layers"]]
    s1, tok1, cen1 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    # a poisoned attempt in between changes nothing either
    _, _, bad = peng.decode(state, [float("nan")] + [1.0] * (SLOTS - 1), "cuda_fused")
    assert bad[0] > 0
    s2, tok2, cen2 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_array_equal(cen1, cen2)
    for a, b, c in zip(s1["caches"]["layers"], s2["caches"]["layers"],
                       state["caches"]["layers"]):
        for key in ("conv", "state"):
            assert torch.equal(a[key], b[key])
            assert a[key].data_ptr() != c[key].data_ptr()  # new tensors
    for before, after in zip(committed, state["caches"]["layers"]):
        for key in ("conv", "state"):
            assert torch.equal(before[key], after[key])


def _serve(engine, prompts, chaos=None):
    runtime = ServingRuntime(engine, chaos=chaos)
    results = runtime.serve([Request(rid=i, prompt=p, max_new=4)
                             for i, p in enumerate(prompts)])
    assert all(r.ok for r in results)
    return [list(r.tokens) for r in results], runtime


def test_chaos_run_equals_clean_run_bitwise(engines):
    _, peng = engines
    prompts = [_rng(30 + i).integers(0, 256, size=(8,)).astype(np.int32) for i in range(8)]
    clean, _ = _serve(peng, prompts)
    chaos = ChaosMonkey.from_seed(7, n_steps=8, nan_rate=0.15, fail_rate=0.15,
                                  preempt_rate=0.1)
    assert chaos.nan_steps or chaos.fail_steps
    got, runtime = _serve(peng, prompts, chaos)
    assert got == clean
    assert runtime.metrics.snapshot()["retries"] > 0


def test_train_steps_lower_the_loss():
    cfg = get_arch(ARCH, tiny=True)
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=6, warmup_steps=1)
    params, opt, step = train_cli.build(cfg, tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(SyntheticLM(cfg.vocab_size, 16, 2, seed=1)
                                        .next()["tokens"])}
    losses = []
    for _ in range(5):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1


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
    for step in range(1, steps + 1):
        tokens = data.next()["tokens"]
        rparams, ropt, rm = rstep(rparams, ropt, {"tokens": jnp.asarray(tokens)})
        pparams, popt, pm = pstep(pparams, popt, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3
        for key in ("grad_norm", "clip", "lr"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=1e-4), key
        want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rparams), pcfg))
        got = [p.detach() for p in R.tree_leaves(pparams)]
        diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, got)])
        assert float(diffs.max()) <= 2 * lr * step
        assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()
