"""Port parity of the audio family (musicgen-medium: four codebook streams,
a parametric LayerNorm, the GELU FFN) against the reference, from the same
weights and the same tokens.

  * the config field by field, full and tiny, ``param_count`` 1 384 120 320;
    the stored counts (``stored_param_count`` against ``init_params`` on the
    CPU at tiny size and on the meta device at full size, and against the
    reference's tree), the leaves (484 at full size: the clip statistic
    goes past K4's 128 parts) and the serving bytes;
  * ``norm_apply("layernorm")`` with a scale and a bias, and its gradient,
    on the kernel route (which launches no kernel for it: the engine's row
    moments, as the reference's ``use_pallas`` route);
  * the GELU FFN (tanh form), with a planted fault (the exact erf form)
    failing its limit;
  * ``_embed`` (the K streams summed in order) and ``_head`` (one head a
    stream);
  * ``lm_loss_chunked`` with (B, S, K) labels at S = 2 x chunk + 3 (the pad
    on the sequence axis), against the reference's and the unchunked loss;
  * tiny musicgen's forward, prefill and decode logits and the guarded
    engine's tokens against ``repro.launch.serve.GuardedEngine``, a planted
    fault (the codebook heads rolled by one stream) failing the limit, a
    retried decode step bitwise, two train steps against
    ``make_train_step``;
  * the serve and train CLIs with ``--device cpu``, and the training CLI's
    fit check accepting full depth on an 80 GB card.

Tolerances: the norm 1e-5 (f32; the same bf16 splits of the moments,
summed in other orders; observed ~1e-6), its gradients 1e-4 of each one's
largest element; the FFN 1e-5 (f32); ``_embed`` bitwise (the same adds in
the same order), ``_head`` 1e-5; the chunked loss 1e-5 (f32 sums of the
same per-token losses in other orders) and its gradient 1e-5 of its
largest element. The logits are held within 0.01, the card-vs-CPU limit of
``chip_smoke.py``: over the prompt seeds 0 to 5 the tiny forward's logits
sit within 2e-5 of the reference's at four seeds and 1.0e-3 / 1.1e-3 at
the other two, where an input 5e-6 apart (f32 sums in other orders) flips
one bf16 rounding of attention's q, k, v or p in the third layer, and the
flip carries to the logits; the same layer from the same input is within
6e-7. The planted fault moves the logits by more than 0.1. The train steps
as ``tests/test_torch_dense_archs.py``'s (loss 1e-3, parameters within 2 lr
x steps with all but 0.1% within 1e-5), but the grad norm and the clip
within 1e-3 relative, ``chip_smoke.py``'s card-vs-CPU limit, not 1e-4: at
this batch the port's own step-1 gradients move by up to 3.8e-4 of a
leaf's largest element when the weights are multiplied by 1 + 1e-7 N(0, 1)
(the bf16 flips above; tiny internlm2's do not move), and the step-2 norm
sits 1.06e-4 from the reference's (step 1: 5.5e-6).
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
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import losses as RLOSS
from repro.models import model as RM
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import forward, init_params
from repro_torch.models import layers as L
from repro_torch.models import losses as LOSS
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, reference_leaf_groups
from repro_torch.models.frontends import synth_codebook_tokens
from repro_torch.models.model import stored_param_count
from repro_torch.models.params import count_params
from test_torch_rglru import assert_config_is_the_reference

ARCH = "musicgen-medium"
BOOKS = 4
SLOTS, PROMPT, NEW = 2, 8, 4
S_MAX = PROMPT + NEW + 1
LOGIT_ATOL = 0.01
GRAD_NORM_RTOL = 1e-3


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cfgs():
    return dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True), get_arch(ARCH, True)


def _heads_rolled(params):
    """A planted fault: stream k read by the head of stream k - 1."""
    return dict(params, head={"w": params["head"]["w"].roll(1, 0)})


# --------------------------------- config ---------------------------------


def test_config_counts_and_shapes_are_the_reference():
    assert_config_is_the_reference(ARCH)
    full = get_arch(ARCH)
    assert full.param_count() == 1_384_120_320
    assert (full.n_codebooks, full.norm, full.ffn_kind) == (BOOKS, "layernorm", "gelu")
    assert full.n_heads == full.n_kv_heads == 24 and full.d_head == 64


def test_stored_counts_leaves_and_serving_bytes():
    cfg = get_arch(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(ARCH, tiny=True))
    assert count_params(params) == stored_param_count(cfg) == \
        sum(x.size for x in jax.tree.leaves(rparams))
    # the table is not vocabulary-padded; the K heads are (64 -> 256)
    assert params["embed"]["table"].shape == (BOOKS, 64, 64)
    assert params["head"]["w"].shape == (BOOKS, 64, 256)
    assert stored_param_count(cfg) - cfg.param_count() == \
        BOOKS * 64 * (256 - 64) + (3 * 2 + 1) * 2 * 64  # head pad; scales and biases
    norm = params["layers"][0]["norm1"]
    assert torch.equal(norm["scale"], torch.ones(64)) and torch.equal(norm["bias"], torch.zeros(64))
    assert train_cli.param_leaves(cfg) == len(R.tree_leaves(params)) == 3 * 10 + 4
    eng = GuardedEngine(cfg, S_MAX, SLOTS, device="cpu", params=params)
    caches = eng._prefill(eng.params, eng._pack_wave([np.zeros(4, np.int32)] * SLOTS))[1]
    held = sum(t.numel() * t.element_size()
               for t in R.tree_leaves(eng.params) + R.tree_leaves(caches))
    assert serve_cli.serve_state_bytes(cfg, SLOTS, S_MAX) == held
    full = get_arch(ARCH)
    meta = init_params(full, torch.Generator().manual_seed(0), torch.device("meta"))
    assert count_params(meta) == stored_param_count(full) == \
        full.param_count() + (48 * 2 + 1) * 2 * 1536  # 2048 columns: no pad
    assert train_cli.param_leaves(full) == len(R.tree_leaves(meta)) == 48 * 10 + 4 == 484
    assert 3.09e9 < serve_cli.serve_state_bytes(full, 4, 273) < 3.10e9  # weights, KV caches


def test_fit_check_accepts_full_depth(monkeypatch):
    full = get_arch(ARCH)
    tcfg = TrainConfig()
    # 1.384 B parameters: bf16 values and gradients, f32 moments and
    # accumulators, and past 128 leaves the clip statistic's 8-byte pack
    peak = train_cli.train_step_peak_bytes(full, tcfg)
    assert peak == train_cli.train_step_peak_bytes(full, tcfg, guard=True)
    assert 30.4e9 < peak < 30.5e9

    class Props:
        total_memory = 85_045_395_456  # an H100 80GB HBM3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    for guard in (False, True):
        train_cli.check_fits_card(full, tcfg, torch.device("cuda"), guard=guard)


# ----------------------------- the modules --------------------------------


def test_layernorm_and_its_gradient_match_reference():
    x = (_rng(1).standard_normal((2, 9, 64)) * 3 + 1).astype(np.float32)
    scale = (_rng(2).uniform(0.5, 1.5, 64)).astype(np.float32)
    bias = _rng(3).standard_normal(64).astype(np.float32)
    w = _rng(4).standard_normal((2, 9, 64)).astype(np.float32)

    def ref_loss(xx, p):
        return jnp.sum(RL.norm_apply("layernorm", p, xx, eps=1e-5, mma=True, use_pallas=True)
                       * w)

    rp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(RL.norm_apply("layernorm", rp, jnp.asarray(x), eps=1e-5, mma=True,
                                    use_pallas=True))
    rgx, rgp = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), rp)
    xt = torch.from_numpy(x).requires_grad_(True)
    pp = {"scale": torch.from_numpy(scale).requires_grad_(True),
          "bias": torch.from_numpy(bias).requires_grad_(True)}
    got, launches = R.count_kernel_launches(
        L.norm_apply, "layernorm", pp, xt, eps=1e-5, mma=True, use_kernels=True,
        include_plain=True)
    assert not any(launches.values())  # no norm kernel: the engine's moments
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for name, t, ref in (("x", xt, rgx), ("scale", pp["scale"], rgp["scale"]),
                         ("bias", pp["bias"], rgp["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()), err_msg=name)


def test_gelu_ffn_matches_reference_with_a_planted_fault(monkeypatch):
    rp, _ = RL.ffn_init(jax.random.PRNGKey(2), 64, 128, "gelu", jnp.float32)
    pp = {k: {"w": torch.from_numpy(np.array(v["w"]))} for k, v in rp.items()}
    assert set(pp) == {"up", "down"}
    mine = L.ffn_init(torch.Generator().manual_seed(0), 64, 128, "gelu", torch.float32, "cpu")
    assert {k: v["w"].shape for k, v in mine.items()} == \
        {"up": (64, 128), "down": (128, 64)}
    x = _rng(5).standard_normal((2, 7, 64)).astype(np.float32)
    want = np.asarray(RL.ffn_apply(rp, jnp.asarray(x), "gelu"))
    got = L.ffn_apply(pp, torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    exact = torch.nn.functional.gelu
    monkeypatch.setattr(L.F, "gelu", lambda t, approximate="none": exact(t))
    wrong = L.ffn_apply(pp, torch.from_numpy(x), "gelu")
    assert float(np.abs(wrong.numpy() - want).max()) > 1e-5


def test_embed_and_head_with_codebooks_match_reference():
    rcfg, pcfg = _cfgs()
    for dtype in ("float32", "bfloat16"):
        rc = dataclasses.replace(rcfg, dtype=dtype)
        pc = dataclasses.replace(pcfg, dtype=dtype)
        rparams, _ = ref_init_params(jax.random.PRNGKey(3), rc)
        pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pc)
        toks = _rng(6).integers(0, 64, size=(2, 7, BOOKS))
        want = np.asarray(RM._embed(rparams, rc, jnp.asarray(toks, jnp.int32)).astype(
            jnp.float32))
        got = M._embed(pparams, pc, torch.from_numpy(toks))
        assert got.dtype == M.param_dtype(pc)
        np.testing.assert_array_equal(got.float().numpy(), want)  # the same adds, in order
    h = _rng(7).standard_normal((2, 7, 64)).astype(np.float32)
    want = np.asarray(RM._head(rparams, rcfg, jnp.asarray(h)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    got = M._head(pparams, pcfg, torch.from_numpy(h))
    assert got.shape == want.shape == (2, 7, BOOKS, 256)
    assert bool((got[..., 64:] == -1e30).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wrong = M._head(_heads_rolled(pparams), pcfg, torch.from_numpy(h))
    assert float(np.abs(wrong[..., :64].numpy() - want[..., :64]).max()) > 0.1


def test_chunked_loss_with_codebook_labels_and_a_sequence_pad():
    rcfg, pcfg = _cfgs()
    chunk = 4
    b, s = 2, 2 * chunk + 3
    rparams, _ = ref_init_params(jax.random.PRNGKey(4), rcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    h = _rng(8).standard_normal((b, s, 64)).astype(np.float32)
    labels = _rng(9).integers(0, 64, size=(b, s, BOOKS)).astype(np.int32)
    aux = jnp.zeros((), jnp.float32)

    def ref_loss(hh):
        return RLOSS.lm_loss_chunked(rparams, rcfg, hh, jnp.asarray(labels), aux,
                                     seq_chunk=chunk)[0]

    want = float(ref_loss(jnp.asarray(h)))
    want_grad = np.asarray(jax.grad(ref_loss)(jnp.asarray(h)))
    ht = torch.from_numpy(h).requires_grad_(True)
    got, parts = LOSS.lm_loss_chunked(pparams, pcfg, ht, torch.from_numpy(labels),
                                      torch.zeros(()), seq_chunk=chunk)
    (grad,) = torch.autograd.grad(got, ht)
    assert abs(float(got.detach()) - want) <= 1e-5
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * float(np.abs(want_grad).max()))
    # the unchunked loss over the public logits: the mean over every token
    # and stream
    logits = M._head_public(pparams, pcfg, ht.detach())
    full, _ = LOSS.lm_loss(logits, torch.from_numpy(labels), torch.zeros(()), pcfg)
    assert abs(float(full) - float(got)) <= 1e-5
    assert abs(float(parts["ce"]) - want) <= 1e-5


def test_synth_codebook_tokens_shape_dtype_and_seed():
    a = synth_codebook_tokens(torch.Generator().manual_seed(1), 3, 50, BOOKS, 2048)
    b = synth_codebook_tokens(torch.Generator().manual_seed(1), 3, 50, BOOKS, 2048)
    c = synth_codebook_tokens(torch.Generator().manual_seed(2), 3, 50, BOOKS, 2048)
    assert a.shape == (3, 50, BOOKS) and a.dtype == torch.int32 and a.device.type == "cpu"
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 2048


# ----------------------------- tiny musicgen ------------------------------


def _engines():
    rcfg, pcfg = _cfgs()
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    return reng, GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_forward_logits_match_reference_with_a_planted_fault(engines):
    reng, peng = engines
    toks = _rng(1).integers(0, 64, size=(2, 12, BOOKS))
    want, _ = ref_forward(reng.params, reng.cfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, aux = forward(peng.params, peng.cfg, torch.from_numpy(toks))
        wrong, _ = forward(_heads_rolled(peng.params), peng.cfg, torch.from_numpy(toks))
    assert got.shape == want.shape == (2, 12, BOOKS, 64) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert float(np.abs(wrong.numpy() - np.asarray(want)).max()) > 10 * LOGIT_ATOL


def test_prefill_and_decode_logits_match_reference(engines):
    reng, peng = engines
    prompts = _rng(2).integers(0, 64, size=(SLOTS, PROMPT, BOOKS))
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(prompts))
    assert got.shape == want.shape == (SLOTS, 1, BOOKS, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    rdec = jax.jit(ref_decode_step(reng.cfg, greedy=False))
    toks = _rng(3).integers(0, 64, size=(2, SLOTS, 1, BOOKS))
    for t in range(2):
        pos = PROMPT + t
        want, rcache = rdec(reng.params, rcache, jnp.asarray(toks[t], jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            got, pcache = peng._decode_logits(peng.params, pcache, torch.from_numpy(toks[t]),
                                              pos)
        assert got.shape == (SLOTS, 1, BOOKS, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_guarded_prefill_and_decode_tokens_match_reference(engines):
    reng, peng = engines
    # 1-D prompts are tiled over the streams on both sides; one slot short
    prompts = [_rng(10 + i).integers(0, 64, size=(PROMPT,)).astype(np.int32)
               for i in range(SLOTS - 1)]
    assert tuple(peng._pack_wave(prompts).shape) == (SLOTS, PROMPT, BOOKS)
    scales = [1.0] * SLOTS
    rstate, rtok, rcen = reng.start_wave(prompts, scales, "pallas_fused")
    pstate, ptok, pcen = peng.start_wave(prompts, scales, "cuda_fused")
    assert pstate["tok"].shape == (SLOTS, 1, BOOKS)
    toks = [(rtok, ptok)]
    for _ in range(NEW - 1):
        rstate, rtok, rcen = reng.decode(rstate, scales, "pallas_fused")
        pstate, ptok, pcen = peng.decode(pstate, scales, "cuda_fused")
        toks.append((rtok, ptok))
        np.testing.assert_array_equal(pcen, np.asarray(rcen))
        np.testing.assert_array_equal(np.asarray(pstate["tok"]), np.asarray(rstate["tok"]))
    for rt, pt in toks:  # codebook 0 of each slot
        assert pt.shape == (SLOTS,)
        np.testing.assert_array_equal(pt, np.asarray(rt))
    _, _, bad = peng.decode(pstate, [float("nan")] + scales[1:], "cuda_fused")
    assert bad[0] > 0 and bad[-1] > 0


def test_decode_step_issued_twice_is_bitwise(engines):
    _, peng = engines
    prompts = [_rng(7 + i).integers(0, 64, size=(PROMPT, BOOKS)) for i in range(SLOTS)]
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


def test_tiny_train_steps_match_reference(kernel_backends):
    steps = 2
    rcfg, pcfg = _cfgs()
    kw = dict(total_steps=steps, warmup_steps=1)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ropt = RO.init_state(rparams)
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(**kw)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    # the codebook table and heads and the LayerNorms' biases are carried
    # across, each its own reference leaf
    assert len(set(reference_leaf_groups(pparams, pcfg))) == len(jax.tree.leaves(rparams))
    assert torch.equal(pparams["embed"]["table"],
                       torch.from_numpy(np.array(rparams["embed"]["table"])))
    pparams, popt, pstep = train_cli.build(pcfg, TrainConfig(**kw), "cpu", params=pparams)
    data = RefSyntheticLM(pcfg.vocab_size, 16, 2, seed=0, n_codebooks=BOOKS)
    lr = TrainConfig().learning_rate
    for step in range(1, steps + 1):
        tokens = data.next()["tokens"]
        assert tokens.shape == (2, 17, BOOKS)
        rparams, ropt, rm = rstep(rparams, ropt, {"tokens": jnp.asarray(tokens)})
        (pparams, popt, pm), launches = R.count_kernel_launches(
            pstep, pparams, popt, {"tokens": torch.from_numpy(tokens)}, include_plain=True)
        # no norm kernel; K6 forward and recompute, K7 forward and
        # recompute, one K1 token sum, one K4 clip statistic (34 leaves)
        assert (launches["layernorm_np"], launches["rmsnorm"]) == (0, 0)
        assert (launches["flash_attention"], launches["cross_entropy"],
                launches["mma_sum_fused"], launches["mma_sum_parts"]) == (6, 2, 1, 1)
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3
        for key in ("grad_norm", "clip"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=GRAD_NORM_RTOL), key
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rparams), pcfg))
        got = [p.detach() for p in R.tree_leaves(pparams)]
        diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, got)])
        assert float(diffs.max()) <= 2 * lr * step
        assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()
    assert not torch.equal(pparams["layers"][0]["norm1"]["bias"].detach(), torch.zeros(64))


# ---------------------------------- CLIs ----------------------------------


def test_serve_cli_on_cpu(capsys):
    results = serve_cli.main(["--arch", ARCH, "--tiny", "--guard", "--device", "cpu",
                              "--requests", "3", "--batch-slots", "2", "--prompt-len", "6",
                              "--max-new", "3"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(r.ok and len(r.tokens) == 3 for r in results)
    assert all(0 <= t < 64 for r in results for t in r.tokens)
    assert "served 3/3 requests" in out
    outs = serve_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--requests", "2",
                           "--batch-slots", "2", "--prompt-len", "6", "--max-new", "3"])
    assert [list(r.tokens) for r in results[:2]] == outs  # the plain loop: the same tokens


def test_train_cli_on_cpu(capsys):
    try:
        losses = train_cli.main(["--arch", ARCH, "--tiny", "--steps", "2", "--batch", "2",
                                 "--seq", "16", "--log-every", "1", "--device", "cpu",
                                 "--reduce-backend", "cuda_fused"])
    finally:
        R.set_default_backend(None)
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.count("ms/step") == 2 and "arch=musicgen-tiny" in out
