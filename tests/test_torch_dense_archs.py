"""Port parity of the dense archs internlm2-1.8b (GQA, untied head, RMSNorm)
and deepseek-7b (MHA at d = 4096, untied head, RMSNorm), and of the MoE
archs granite-moe-1b-a400m (32 experts top-8, GQA heads of 64, tied
embeddings) and dbrx-132b (16 experts top-4, 48 query heads on 8 kv heads,
untied head; heads of 8 at its tiny size).

  * ``param_count()`` and ``active_param_count()`` at full and tiny size
    against the reference's; the training CLI's leaf count against the
    tree's.
  * Tiny-config prefill and two teacher-forced decode steps from the
    reference's own weights (``params_from_jax``, the untied head carried
    across), against ``repro.launch.serve.GuardedEngine`` with
    ``use_pallas=True`` (Pallas kernels in interpret mode).
  * Two train steps from those weights on ``cuda_fused`` (plain versions on
    the CPU) against the reference on pallas_fused.
  * The clip statistic past 128 leaves: tiny-width internlm2 cut to 15
    layers has 138 port leaves, so the guarded statistic leaves the parts
    kernel (K4, at most 128 parts) for the reference's route, the f32 pack
    and one segmented gather (K8) with the census counted on the host; the
    reference stacks the same tensors into 12 leaves and takes one K4. Both
    give the norm, the clip coefficient and the NaN/Inf counts.

Tolerances: as ``tests/test_torch_serve.py`` (logits 1e-4 in f32: both
sides round the same intermediates to bf16 and sum in other orders) and
``tests/test_torch_train.py`` (loss 1e-3, grad norm and clip 1e-4
relative, parameters within 2 lr x steps with all but 0.1% within 1e-5).
The MoE archs' train steps are held to the same tolerances. Their
logits are held within 0.01, the card-vs-CPU limit of ``chip_smoke.py``:
the 1e-4 above is a property of the seed, not of the port. Over 12 prompt
seeds the prefill logits of every tiny arch, dense included, leave 1e-4
on 2 to 5 of them (up to 1.8e-3), and at this test's seed granite's
decode steps do (1.1e-4, 1.5e-4): inputs 7e-7 apart (f32 sums of other
orders) cross a bf16 rounding of attention's q, k, v or p on one side
only (tiny granite's third layer: attention outputs 9e-4 apart), and the
flip carries to the logits. A planted routing fault (every token sent to
the next expert) must fail the 0.01 limit. ``tests/test_torch_moe.py``
holds the routing tables themselves exactly.
The >128-leaf statistic: norm and clip 1e-5 relative (f32 sums of the
same squares in other orders: the pack folds 138 segments, K4 12 parts);
the census counts exactly.
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
from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import GuardedEngine
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax, reference_leaf_groups
from repro_torch.models.params import count_params, padded_vocab

ARCHS = ["internlm2-1.8b", "deepseek-7b", "granite-moe-1b-a400m", "dbrx-132b"]
UNTIED = [a for a in ARCHS if a != "granite-moe-1b-a400m"]
SLOTS, PROMPT, S_MAX = 2, 8, 16
LOGIT_ATOL = 1e-4
MOE_LOGIT_ATOL = 0.01
BATCH, SEQ, STEPS = 2, 16, 2


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch, tiny):
    assert get_arch(arch, tiny).param_count() == ref_arch(arch, tiny).param_count()
    assert get_arch(arch, tiny).active_param_count() == ref_arch(arch, tiny).active_param_count()


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_arch(a).moe is not None])
def test_moe_leaves_counted_and_carried_across(arch):
    cfg = get_arch(arch, tiny=True)
    e = cfg.moe
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert train_cli.param_leaves(cfg) == len(R.tree_leaves(params))
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(arch, tiny=True))
    assert count_params(params) == sum(x.size for x in jax.tree.leaves(rparams))
    ffn = params["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].shape == (cfg.d_model, e.n_experts)
    assert ffn["up"].shape == (e.n_experts, cfg.d_model, e.d_ff_expert)
    assert ffn["down"].shape == (e.n_experts, e.d_ff_expert, cfg.d_model)
    # the carried-across tree maps its stacked expert leaves onto the
    # reference's, one group per reference leaf
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), cfg)
    groups = reference_leaf_groups(pparams, cfg)
    assert len(set(groups)) == len(jax.tree.leaves(rparams))
    stacked = rparams["units"]["pos0"]["ffn"]
    for i, layer in enumerate(pparams["layers"]):
        for name, leaf in layer["ffn"].items():
            assert torch.equal(leaf, torch.from_numpy(np.array(stacked[name][i])))


def test_full_width_moe_leaves_and_state():
    assert train_cli.param_leaves(get_arch("granite-moe-1b-a400m")) == 242
    granite = get_arch("granite-moe-1b-a400m")
    # 1.335 B parameters at 20 bytes (past 128 leaves: the clip pack too),
    # the f32 routers (24 x 1024 x 32) 4 bytes more each in the parameters
    # and the gradients
    assert train_cli.train_state_bytes(granite, TrainConfig()) == \
        granite.param_count() * 20 + 24 * 1024 * 32 * 4
    assert 26e9 < train_cli.train_state_bytes(granite, TrainConfig()) < 27e9


@pytest.mark.parametrize("arch", UNTIED)
def test_untied_head_initialised_and_counted(arch):
    cfg = get_arch(arch, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["head"]["w"].shape == (cfg.d_model, padded_vocab(cfg.vocab_size))
    # the stored tensors, padded vocabulary and norm scales included, are
    # the reference tree's
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), ref_arch(arch, tiny=True))
    assert count_params(params) == sum(x.size for x in jax.tree.leaves(rparams))
    # the training CLI's leaf count (its memory check) is the tree's
    assert train_cli.param_leaves(cfg) == len(R.tree_leaves(params))


def _engines(arch):
    rcfg = dataclasses.replace(ref_arch(arch, tiny=True), use_pallas=True)
    pcfg = get_arch(arch, tiny=True)
    reng = RefEngine(rcfg, S_MAX, SLOTS, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, reng.params), pcfg)
    return reng, GuardedEngine(pcfg, S_MAX, SLOTS, device="cpu", params=params)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    reng, peng = _engines(arch)
    tol = LOGIT_ATOL if peng.cfg.moe is None else MOE_LOGIT_ATOL
    prompts = np.random.default_rng(1).integers(0, 256, size=(SLOTS, PROMPT))
    want, rcache = reng._jit_prefill(reng.params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        got, pcache = peng._prefill(peng.params, torch.from_numpy(prompts.astype(np.int64)))
    assert got.shape == want.shape == (SLOTS, 1, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    rdec = jax.jit(ref_decode_step(reng.cfg, greedy=False))
    toks = np.random.default_rng(2).integers(0, 256, size=(2, SLOTS, 1))
    for t in range(2):
        pos = PROMPT + t
        want, rcache = rdec(reng.params, rcache, jnp.asarray(toks[t], jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            got, pcache = peng._decode_logits(peng.params, pcache, torch.from_numpy(toks[t]),
                                              pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_arch(a).moe is not None])
def test_moe_logit_limit_catches_a_routing_fault(arch, monkeypatch):
    from repro_torch.models import moe as M

    reng, peng = _engines(arch)
    prompts = np.random.default_rng(1).integers(0, 256, size=(SLOTS, PROMPT))
    want, _ = reng._jit_prefill(reng.params, jnp.asarray(prompts, jnp.int32))
    orig = M._dispatch_row
    monkeypatch.setattr(M, "_dispatch_row", lambda ei, gv, E, cap, backend=None:
                        orig((ei + 1) % E, gv, E, cap, backend=backend))
    with torch.inference_mode():
        got, _ = peng._prefill(peng.params, torch.from_numpy(prompts.astype(np.int64)))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) > 10 * MOE_LOGIT_ATOL


@pytest.fixture
def kernel_backends():
    RR.set_default_backend("pallas_fused")
    R.set_default_backend("cuda_fused")
    yield
    RR.set_default_backend(None)
    R.set_default_backend(None)


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_train_steps_match_reference(kernel_backends, arch):
    rcfg = dataclasses.replace(ref_arch(arch, tiny=True), use_pallas=True)
    pcfg = get_arch(arch, tiny=True)
    kw = dict(total_steps=STEPS, warmup_steps=1)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ropt = RO.init_state(rparams)
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(**kw)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    pparams, popt, pstep = train_cli.build(pcfg, TrainConfig(**kw), "cpu", params=pparams)
    # the untied head is its own reference leaf
    assert len(set(reference_leaf_groups(pparams, pcfg))) == len(jax.tree.leaves(rparams))
    data = RefSyntheticLM(pcfg.vocab_size, SEQ, BATCH, seed=0)
    lr = TrainConfig().learning_rate
    for step in range(1, STEPS + 1):
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


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-and-inf"])
def test_clip_statistic_past_128_leaves_matches_reference(poison):
    rcfg = dataclasses.replace(ref_arch("internlm2-1.8b", tiny=True), n_layers=15)
    pcfg = dataclasses.replace(get_arch("internlm2-1.8b", tiny=True), n_layers=15)
    rparams, _ = ref_init_params(jax.random.PRNGKey(3), rcfg)
    # gradient-like values: the weights scaled, a few poisoned
    rng = np.random.default_rng(5)
    rgrads = jax.tree.map(lambda a: np.asarray(a) * rng.uniform(0.5, 2.0), rparams)
    if poison:
        rgrads["units"]["pos0"]["mix"]["k"]["w"][7, 3, 2] = np.nan
        rgrads["head"]["w"][1, 9] = np.inf
    pgrads = params_from_jax(rgrads, pcfg)
    leaves = R.tree_leaves(pgrads)
    assert len(leaves) == 138 > 128 and len(jax.tree.leaves(rgrads)) == 12

    want = RO.global_norm_and_clip(jax.tree.map(jnp.asarray, rgrads), 1.0,
                                   backend="pallas_fused", census=True)
    (got, launches) = R.count_kernel_launches(
        optim.global_norm_and_clip, pgrads, 1.0, backend="cuda_fused", census=True,
        include_plain=True)
    # the pack-plus-K8 route: one gather over the packed stream, no parts launch
    assert launches["mma_sum_segments"] == 1 and launches["mma_sum_parts"] == 0
    gnorm, clip, counts = got
    rnorm, rclip, rcounts = want
    if poison:
        assert not np.isfinite(float(gnorm)) and not np.isfinite(float(rnorm))
    else:
        assert float(gnorm) == pytest.approx(float(rnorm), rel=1e-5)
        assert float(clip) == pytest.approx(float(rclip), rel=1e-5)
    # per-leaf counts differ in layout (138 port leaves, 12 reference
    # leaves); the totals, the last slot, agree exactly
    assert float(counts[-1]) == float(rcounts[-1]) == (2.0 if poison else 0.0)
    groups = reference_leaf_groups(pgrads, pcfg)
    per_ref = np.zeros(12)
    np.add.at(per_ref, np.asarray(groups), counts[:-1].numpy())
    np.testing.assert_array_equal(per_ref, np.asarray(rcounts[:-1]))


def test_train_cli_refuses_a_state_larger_than_the_card(monkeypatch):
    tcfg = TrainConfig()
    assert train_cli.param_leaves(get_arch("internlm2-1.8b")) == 219
    assert train_cli.param_leaves(get_arch("deepseek-7b")) == 273
    # deepseek-7b: ~83 GB of parameters, gradients and AdamW moments
    base = get_arch("deepseek-7b").param_count() * 12
    assert 82e9 < base < 84e9
    assert train_cli.train_state_bytes(get_arch("deepseek-7b"), tcfg) == base + \
        get_arch("deepseek-7b").param_count() * 8

    class Props:
        total_memory = 85 * 10**9  # an 80 GB card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "deepseek-7b", "--steps", "1"])


def test_serving_entry_refuses_a_state_larger_than_the_card(monkeypatch):
    from repro_torch.launch import serve as serve_cli

    dbrx = get_arch("dbrx-132b")
    need = serve_cli.serve_state_bytes(dbrx, 4, 273)
    assert 263e9 < need < 264e9  # 131.6 B parameters at bf16, and the caches

    class Props:
        total_memory = 85 * 10**9  # an 80 GB card

    def no_alloc(*args, **kwargs):
        raise AssertionError("the engine allocated parameters before its size check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(serve_cli, "init_params", no_alloc)
    with pytest.raises(ValueError, match="sharded over more cards"):
        serve_cli.GuardedEngine(dbrx, 273, 4)
    with pytest.raises(ValueError, match="sharded over more cards"):
        serve_cli.main(["--arch", "dbrx-132b", "--guard", "--prompt-len", "256"])
    # what fits is served unchanged: dbrx at full width on 2 layers
    # (~15.5 GB), granite and the dense archs at full depth
    cuda = torch.device("cuda")
    two = dataclasses.replace(dbrx, n_layers=2)
    assert 15e9 < serve_cli.serve_state_bytes(two, 4, 273) < 16e9
    for cfg in (two, get_arch("granite-moe-1b-a400m"), get_arch("deepseek-7b")):
        serve_cli.check_fits_card(cfg, 4, 273, cuda)
    # the CPU has no card to refuse for
    serve_cli.check_fits_card(dbrx, 4, 273, torch.device("cpu"))
