"""Port parity of the RG-LRU block (``repro_torch.models.rglru``) and of
recurrentgemma-9b, against ``repro.models.rglru`` and the reference's
engine from the same weights, carried across.

  * ``associative_scan`` against ``jax.lax.associative_scan`` with the
    same combine at lengths 1, 5 and 37, f32 and bf16, and against a
    sequential f64 loop;
  * ``_gates`` and ``rglru_train`` against the reference, with the
    gradients to every parameter and to x;
  * the ``rglru_train(return_state=True)`` -> ``rglru_decode`` handoff at a
    prompt of 5 and 23 tokens, against the reference's and against the
    train path on more tokens; a 2-token prompt's conv window front-padded;
  * the decode step returns new tensors, leaves its cache untouched and
    repeats bitwise;
  * tiny recurrentgemma (pattern (rec, rec, local_attn), window 16, 5
    layers: one unit and a (rec, rec) tail): the config field by field,
    the counts (``param_count``, ``active_param_count``, ``subquadratic``,
    ``shape_applicable`` over the four shapes, full and tiny;
    ``stored_param_count``, ``param_leaves``, the f32 ``lam`` and the
    serving bytes against what ``init_params`` and an engine hold), the
    reference's tree carried across with its tail, prefill then decode
    past the window (the prompt of 20 takes the ring branch, the decode
    wraps) against the reference's engine and the port's own forward,
    two train steps against the reference's, a decode step issued twice
    bitwise with the committed caches untouched, and the training CLI
    refusing full depth on a mocked 80 GB card.

Tolerances:
  * the scan at f32 1e-6 of the largest |h| (observed: bitwise, the same
    combines in the same order); at bf16 each combine rounds in bf16 on
    both sides, 2 bf16 ulps of the largest |h|; against the f64 loop 1e-5
    (f32) and 0.1 (bf16: 2 log2(L) roundings);
  * the block 1e-5 at ~1.5 (observed 3e-7: f32 sums of other orders),
    gradients 1e-4 of each one's largest element; the handoff 1e-5;
  * the logits against the reference 6e-3, the reference's envelope for
    these caches (``tests/test_serving_consistency.py``: its ``ATOL``;
    observed up to 6.3e-4: the reference's kernels in interpret mode round
    attention's q, k, v and p to bf16 in another order than the plain
    versions here), and against the port's own forward 6e-3 + 1e-3
    relative (observed 3.3e-6);
  * the train steps: loss 1e-3, grad norm and clip 1e-4 relative,
    parameters within 2 lr x steps with all but 0.1% within 1e-5 (the
    tolerances of ``tests/test_torch_dense_archs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro import reduce as RR
from repro.configs import ALL_SHAPES as REF_SHAPES
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_arch as ref_arch
from repro.configs import shape_applicable as ref_shape_applicable
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.serve import GuardedEngine as RefEngine
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init_params
from repro.models import rglru as RREC
from repro_torch import reduce as R
from repro_torch.configs import ALL_SHAPES, TrainConfig, get_arch, shape_applicable
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import forward, init_params
from repro_torch.models import rglru as REC
from repro_torch.models.convert import params_from_jax, reference_leaf_groups, tensor_from_numpy
from repro_torch.models.model import f32_param_count, stored_param_count
from repro_torch.models.params import count_params

ARCH = "recurrentgemma-9b"
SLOTS, PROMPT, NEW = 2, 20, 6
S_MAX = PROMPT + NEW + 1
LOGIT_ATOL = 6e-3
SELF_ATOL, SELF_RTOL = 6e-3, 1e-3


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _combine(e1, e2):
    return e1[0] * e2[0], e2[0] * e1[1] + e2[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 5, 37])
def test_associative_scan_matches_jax(length, dtype):
    rng = _rng(length)
    a = rng.uniform(0.5, 1.0, (2, length, 24)).astype(np.float32)
    b = rng.standard_normal((2, length, 24)).astype(np.float32)
    ja, jb = (jnp.asarray(t).astype(dtype) for t in (a, b))
    _, want = jax.lax.associative_scan(_combine, (ja, jb), axis=1)
    want = np.asarray(want.astype(jnp.float32))
    ta, tb = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, b))
    _, got = REC.associative_scan(ta, tb)
    assert got.dtype == ta.dtype and got.shape == tb.shape
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    tol = 1e-6 * scale if dtype == "float32" else 2 * 2.0**-8 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # a sequential loop in f64 over the values the scan was given
    a64 = ta.double().numpy()
    b64 = tb.double().numpy()
    h, seq = np.zeros((2, 24)), []
    for t in range(length):
        h = a64[:, t] * h + b64[:, t]
        seq.append(h)
    np.testing.assert_allclose(got, np.stack(seq, 1), rtol=0,
                               atol=(1e-5 if dtype == "float32" else 0.1) * scale)


def _block(seed=0, dtype="float32"):
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), dtype=dtype)
    pcfg = dataclasses.replace(get_arch(ARCH, tiny=True), dtype=dtype)
    rp, _ = RREC.rglru_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, rp, _torch_tree(rp)


def test_gates_and_train_match_reference_with_gradients():
    rcfg, pcfg, rp, pp = _block(1)
    x = _rng(2).standard_normal((2, 23, pcfg.d_model)).astype(np.float32)
    w = _rng(3).standard_normal(x.shape).astype(np.float32)
    # the gates alone
    u = _rng(4).standard_normal((2, 7, 64)).astype(np.float32)
    ra, rb = RREC._gates(rp, jnp.asarray(u), rcfg)
    pa, pb = REC._gates(pp, torch.from_numpy(u), pcfg)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ra), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb.numpy(), np.asarray(rb), rtol=0, atol=1e-6)

    def ref_loss(p, xx):
        return jnp.sum(RREC.rglru_train(p, xx, rcfg) * w)

    rout = RREC.rglru_train(rp, jnp.asarray(x), rcfg)
    rgp, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: (v["w"] if isinstance(v, dict) else v) for k, v in pp.items()}
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = REC.rglru_train(pp, xt, pcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout), rtol=0, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for name, t in leaves.items():
        want = np.asarray(rgp[name]["w"] if isinstance(rgp[name], dict) else rgp[name])
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    rgx = np.asarray(rgx)
    np.testing.assert_allclose(xt.grad.numpy(), rgx, rtol=0, atol=1e-4 * float(np.abs(rgx).max()))


@pytest.mark.parametrize("prompt", [5, 23])
def test_train_to_decode_handoff_matches_reference(prompt):
    rcfg, pcfg, rp, pp = _block(5)
    x = _rng(6).standard_normal((2, prompt + 3, pcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        full = REC.rglru_train(pp, torch.from_numpy(x), pcfg)
        out, cache = REC.rglru_train(pp, torch.from_numpy(x[:, :prompt]), pcfg,
                                     return_state=True)
    rout, rcache = RREC.rglru_train(rp, jnp.asarray(x[:, :prompt]), rcfg, return_state=True)
    assert cache["h"].dtype == torch.float32 and cache["conv"].shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=0, atol=1e-5)
    for key in ("conv", "h"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]), rtol=0,
                                   atol=1e-5)
    for t in range(3):
        xt = x[:, prompt + t:prompt + t + 1]
        with torch.no_grad():
            yt, cache = REC.rglru_decode(pp, torch.from_numpy(xt), cache, pcfg)
        ryt, rcache = RREC.rglru_decode(rp, jnp.asarray(xt), rcache, rcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(ryt), rtol=0, atol=1e-5)
        np.testing.assert_allclose(yt.numpy(), full[:, prompt + t:prompt + t + 1].numpy(),
                                   rtol=0, atol=1e-5)


def test_short_prompt_conv_window_is_front_padded():
    _, pcfg, _, pp = _block(2)
    x = torch.from_numpy(_rng(7).standard_normal((1, 2, pcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, cache = REC.rglru_train(pp, x, pcfg, return_state=True)
        u_raw = x @ pp["in_x"]["w"]
    assert cache["conv"].shape == (1, 3, 64)
    assert torch.equal(cache["conv"][:, 0], torch.zeros_like(cache["conv"][:, 0]))
    assert torch.equal(cache["conv"][:, 1:], u_raw)


def test_decode_returns_new_state_and_repeats_bitwise():
    _, pcfg, _, pp = _block(3, dtype="bfloat16")
    assert pp["lam"].dtype == torch.float32 and pp["in_x"]["w"].dtype == torch.bfloat16
    x = torch.from_numpy(_rng(8).standard_normal((2, 9, 64)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        _, cache = REC.rglru_train(pp, x[:, :8], pcfg, return_state=True)
        kept = {k: v.clone() for k, v in cache.items()}
        y1, c1 = REC.rglru_decode(pp, x[:, 8:], cache, pcfg)
        y2, c2 = REC.rglru_decode(pp, x[:, 8:], cache, pcfg)
    assert torch.equal(y1, y2)
    for key in ("conv", "h"):
        assert torch.equal(c1[key], c2[key])
        assert torch.equal(cache[key], kept[key])            # the cache given is not written
        assert c1[key].data_ptr() != cache[key].data_ptr()   # new tensors
    assert c1["h"].dtype == torch.float32


# ---------------------------- recurrentgemma-9b ----------------------------

FRAMEWORK = {"use_pallas", "use_kernels"}


def _config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_config_is_the_reference(arch: str) -> None:
    """The port's config equals the reference's field by field (nested
    configs too), the fields the port does not have at their defaults, and
    every derived property and shape cell agrees; full and tiny."""
    for tiny in (False, True):
        pc, rc = get_arch(arch, tiny), ref_arch(arch, tiny)
        pf, rf = _config_fields(pc), _config_fields(rc)
        for name, value in rf.items():
            if name in FRAMEWORK:
                continue
            if name in pf:
                got = pf[name]
                if dataclasses.is_dataclass(value):
                    assert dataclasses.asdict(got) == dataclasses.asdict(value), name
                else:
                    assert got == value, name
            else:
                assert not value, f"{name} is set in the reference but not ported"
        for prop in ("pattern_layers", "attention_free", "subquadratic"):
            assert getattr(pc, prop) == getattr(rc, prop), prop
        assert pc.param_count() == rc.param_count()
        assert pc.active_param_count() == rc.active_param_count()
        for ps, rs in zip(ALL_SHAPES, REF_SHAPES):
            assert shape_applicable(pc, ps) == ref_shape_applicable(rc, rs)


def test_config_counts_and_shapes_are_the_reference():
    assert_config_is_the_reference(ARCH)
    full = get_arch(ARCH)
    assert full.subquadratic and not full.attention_free
    assert shape_applicable(full, ALL_SHAPES[-1])[0]  # long_500k runs
    assert full.pattern_layers[-2:] == ("rec", "rec") and len(full.pattern_layers) == 38


def test_stored_counts_leaves_and_serving_bytes():
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_arch(ARCH, tiny=True), dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(ARCH, tiny=True))
        leaves = R.tree_leaves(params)
        assert count_params(params) == stored_param_count(cfg) == \
            sum(x.size for x in jax.tree.leaves(rparams))
        assert train_cli.param_leaves(cfg) == len(leaves)
        assert [len(R.tree_leaves(layer)) for layer in params["layers"]] == [12, 12, 9, 12, 12]
        f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
        if dtype == "bfloat16":
            assert f32 == f32_param_count(cfg) == 4 * 64  # lam of the four rec blocks
        assert all(layer["mix"]["lam"].dtype == torch.float32
                   for kind, layer in zip(cfg.pattern_layers, params["layers"]) if kind == "rec")
        eng = GuardedEngine(cfg, S_MAX, SLOTS, device="cpu", params=params)
        caches = eng._prefill(eng.params, torch.zeros((SLOTS, 4), dtype=torch.int64))[1]
        ring = caches["layers"][2]
        assert ring["k"].shape == (SLOTS, cfg.window, 1, 16)  # min(S_MAX, window) slots
        assert caches["layers"][0]["h"].dtype == torch.float32
        held = sum(t.numel() * t.element_size()
                   for t in R.tree_leaves(eng.params) + R.tree_leaves(caches))
        assert serve_cli.serve_state_bytes(cfg, SLOTS, S_MAX) == held
    full = get_arch(ARCH)
    assert train_cli.param_leaves(full) == 12 * (12 + 12 + 9) + 2 * 12 + 3
    w = 4096
    # no pad rows (256000 is a multiple of 256); the RMSNorm scales; 26 rec
    # blocks' 2 w^2 / 16 + w values where the formula counts 3 w
    assert stored_param_count(full) - full.param_count() == (
        38 * 2 * 4096 + 4096 + 26 * (2 * w * w // 16 - 2 * w))
    assert 19.2e9 < serve_cli.serve_state_bytes(full, 4, 273) < 19.3e9


def test_reference_tree_carried_across_with_its_tail():
    cfg = get_arch(ARCH, tiny=True)
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), dtype="bfloat16")
    pcfg = dataclasses.replace(cfg, dtype="bfloat16")
    rparams, _ = ref_init_params(jax.random.PRNGKey(1), rcfg)
    np_tree = jax.tree.map(np.asarray, rparams)
    pparams = params_from_jax(np_tree, pcfg)
    assert len(pparams["layers"]) == 5
    for i in range(2):  # the unit's two rec blocks
        assert torch.equal(pparams["layers"][i]["mix"]["in_x"]["w"].view(torch.int16),
                           torch.from_numpy(np.array(np_tree["units"][f"pos{i}"]["mix"]["in_x"]
                                                     ["w"][0]).view(np.int16)))
    for j in range(2):
        layer = pparams["layers"][3 + j]
        tail = np_tree["tail"][f"pos{j}"]
        assert torch.equal(layer["mix"]["lam"], torch.from_numpy(np.array(tail["mix"]["lam"])))
        assert layer["mix"]["lam"].dtype == torch.float32
        assert layer["mix"]["gate_a"].dtype == torch.bfloat16
        assert np.array_equal(layer["mix"]["gate_a"].float().numpy(),
                              tail["mix"]["gate_a"].astype(np.float32))
    groups = reference_leaf_groups(pparams, pcfg)
    assert len(groups) == len(R.tree_leaves(pparams))
    assert len(set(groups)) == len(jax.tree.leaves(rparams))
    assert tail["mix"]["lam"].dtype == np.float32 and tail["mix"]["in_x"]["w"].dtype == \
        ml_dtypes.bfloat16


def _engines():
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=True)
    pcfg = get_arch(ARCH, tiny=True)
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    return reng, GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_then_decode_past_the_window_match_reference_and_forward(engines, seed):
    reng, peng = engines
    assert PROMPT > peng.cfg.window  # the prefill takes the ring branch
    tokens = _rng(seed).integers(0, 256, size=(SLOTS, PROMPT + NEW))
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(tokens[:, :PROMPT], jnp.int32))
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(tokens[:, :PROMPT]))
        full, _ = forward(peng.params, peng.cfg, torch.from_numpy(tokens))
    ring = pcache["layers"][2]["slot_pos"]
    assert sorted(ring.tolist()) == list(range(PROMPT - 16, PROMPT))
    np.testing.assert_array_equal(ring.numpy(),
                                  np.asarray(rcache["units"]["pos2"]["slot_pos"][0]))
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
    prompts = [_rng(9 + i).integers(0, 256, size=(PROMPT,)) for i in range(SLOTS)]
    state, _, _ = peng.start_wave(prompts, [1.0] * SLOTS, "cuda_fused")
    layers = state["caches"]["layers"]
    committed = [{k: v.clone() for k, v in c.items()} for c in layers]
    s1, tok1, cen1 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    _, _, bad = peng.decode(state, [float("nan")] + [1.0] * (SLOTS - 1), "cuda_fused")
    assert bad[0] > 0
    s2, tok2, cen2 = peng.decode(state, [1.0] * SLOTS, "cuda_fused")
    np.testing.assert_array_equal(tok1, tok2)
    np.testing.assert_array_equal(cen1, cen2)
    for kind, a, b, c, before in zip(peng.cfg.pattern_layers, s1["caches"]["layers"],
                                     s2["caches"]["layers"], layers, committed):
        for key in a:
            assert torch.equal(a[key], b[key])
        if kind == "rec":  # new tensors; the committed state bitwise as it was
            for key in ("conv", "h"):
                assert a[key].data_ptr() != c[key].data_ptr()
                assert torch.equal(c[key], before[key])


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
    data = RefSyntheticLM(pcfg.vocab_size, 24, 2, seed=0)  # 24 tokens: past the window
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


def refuses_full_depth(monkeypatch, arch: str, cut_layers: int, leaves: int, gb: tuple,
                       refused_layers: int | None = None):
    """The training CLI refuses ``arch`` at full depth on a mocked 80 GB
    card before it allocates, and accepts it cut to ``cut_layers`` layers
    (``leaves`` leaves, a state of ``gb`` GB); ``refused_layers``, a cut
    that must be refused too."""
    tcfg = TrainConfig()
    full = get_arch(arch)
    cut = dataclasses.replace(full, n_layers=cut_layers)
    assert train_cli.param_leaves(cut) == leaves
    assert gb[0] < train_cli.train_state_bytes(cut, tcfg) / 1e9 < gb[1]

    class Props:
        total_memory = 85_045_395_456  # an H100 80GB HBM3

    def no_alloc(*args, **kwargs):
        raise AssertionError("the CLI allocated parameters before its size check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(train_cli, "init_params", no_alloc)
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="the ROADMAP's sharding item"):
        train_cli.check_fits_card(full, tcfg, cuda)
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", arch, "--steps", "1"])
    if refused_layers is not None:
        with pytest.raises(ValueError, match="the ROADMAP's sharding item"):
            train_cli.check_fits_card(dataclasses.replace(full, n_layers=refused_layers), tcfg,
                                      cuda)
    train_cli.check_fits_card(cut, tcfg, cuda)


def test_train_cli_refuses_full_depth_before_allocating(monkeypatch):
    assert 191e9 < train_cli.train_state_bytes(get_arch(ARCH), TrainConfig()) < 192e9
    refuses_full_depth(monkeypatch, ARCH, 3, 36, (32.2, 32.3))


def test_train_cli_refuses_nine_layers_accepts_six(monkeypatch):
    # 9 layers held 46.4 GB of state and ran out of memory in AdamW on the
    # card: the step's model (train_step_peak_bytes) refuses it
    refuses_full_depth(monkeypatch, ARCH, 6, 69, (39.3, 39.4), refused_layers=9)
