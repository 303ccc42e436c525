"""The sharded training step against the single-device step.

gloo CPU ranks under ``torch.multiprocessing.spawn`` (workers in
``tests/torch_mesh_workers.py``: ``run_mesh``, one spawn per mesh, each
with its own deadline). The weights are the JAX package's ``init_params``
(numpy, carried across by ``models.convert.params_from_jax``), cut by the
rules into each rank's blocks (``launch.sharding.shard_tree``); every rank
gets the same global batch of seeded numpy tokens. The single-device step
is the port's ``make_train_step`` on the whole parameters.

  * tiny deepseek-7b, f32, DEFAULT_RULES (FSDP + TP + vocab TP) on (2, 2),
    two steps, two microbatches: loss, grad norm and every parameter
    within 1e-5 relative (a parameter as ||sharded - single|| / ||single||).
    The f32 cases run the f32 route (no kernels, no ones-MMA rounding) and
    the attention without its bf16 rounding of its operands
    (``exact_f32_attention``): those rounding steps turn a last-bit
    difference of a product taken over a rank's columns into a bf16 ulp
    (~4e-3 relative), which would bury the sharding's own agreement (~1e-7
    measured). A planted fault -- rank 1's Megatron all-reduce 2^-10 too
    large -- must fail that limit, and the replica check.
  * tiny granite-moe-1b-a400m, f32, SMALL_MODEL_RULES (FSDP + vocab TP +
    EP, 4 experts a rank) on (2, 2): the same limit.
  * tiny internlm2-1.8b at bf16 on (2, 4) with the kernel route (their
    plain versions on the CPU), two microbatches of 8 x 32 tokens: the
    counterpart of the reference's own sharded test (2 kv heads x 16 on a
    model axis of 4: a rank's k/v block ends inside a head, so k and v are
    gathered over "model" and the rank's kv head cut out). The learning
    rate is past warmup from step 1 (3e-4), so the AdamW steps move the
    bf16 weights by whole ulps. Limits, each above what bf16 moves: loss
    2e-3 relative (one bf16 ulp of a loss near 6 is 4e-3 absolute, ~6e-4
    relative; the per-token terms round at different points), grad norm
    2e-3 relative (the norm of bf16 gradients whose partial sums round at
    different points), and the update over the two steps (after - before,
    f32) 0.5 relative in every leaf it moves (``_update_gaps``): a step-1
    AdamW update is lr x the gradient's sign a element, and the gradients'
    roundings flip the sign of those near 0 (0.146 measured); the same
    steps with half the batch's rows replaced read 1.2-1.3 in every moved
    leaf, a flipped update 2. A leaf it leaves alone (the norm scales: 3e-4
    is under half a bf16 ulp of 1.0) must stay bitwise alone.
  * the guarded sharded step (deepseek, f32): rank 2's gradients NaN on
    step 2, the step skipped on every rank in lockstep, the blocks
    bitwise unchanged across it, the guard states equal.
  * the other mixers, f32, DEFAULT_RULES on (2, 2), two steps, two
    microbatches, in the same spawn and to the same 1e-5 as deepseek (for
    the same reason): tiny minicpm3-4b (MLA, 2 of 4 heads a rank), tiny
    recurrentgemma-9b (rec, rec, local_attn: the RG-LRU's 32 of 64
    channels a rank, 8 of 16 gate blocks; local attention's one kv head
    gathered over "model"; the soft-capped logits into the vocab-parallel
    loss) and tiny llama-3.2-vision-11b (four attn and one xattn, with a
    seeded numpy context of 16 slots cut by rows with the batch). Every
    cross-attention gate is set to 0.5 in the weights before they are cut,
    for the ranks and the single-device step alike: at init it is 0, the
    block adds nothing and its q, k, v and o get no gradient, so its
    tensor parallelism would go untested. One planted fault a mixer, on
    rank 1, must fail the limit and the replica check: MLA's f dropped on
    the shared RoPE key, the RG-LRU's g 2^-10 too large, cross-attention's
    f dropped on the query input (a backward fault: only an open gate
    shows it).
  * the SSM and the codebook streams, f32 on (2, 2), two steps, two
    microbatches, in the same spawn and to the same 1e-5: tiny mamba2-780m
    under DEFAULT_RULES (the SSM's tensor parallelism: 4 of 8 heads a
    rank, xbc and conv_w gathered over "model" and cut to the rank's x
    heads and all of B and C, the gated norm's statistic summed both
    ways; the tied head vocab-parallel) and under SMALL_MODEL_RULES (FSDP
    and the tied vocab-parallel head alone), and tiny musicgen-medium
    (four codebook streams, tokens below its vocabulary of 64) under
    SMALL_MODEL_RULES and DEFAULT_RULES (the (K, 64, d) table's d FSDP-cut
    and its rows cut 32 a rank, the K heads' columns 128 a rank of the
    padded 256, the K streams' CE). One planted fault each, on rank 1:
    the gated norm's statistic summed forward only (its gradient the
    rank's part), and the codebook lookup's row offset taken from the
    head's ``Plan.vocab0`` (128 on rank 1, where the table's block starts
    at 32).
  * the fused second moment under the sharded step: tiny deepseek-7b f32
    on (2, 2) with ``fused_second_moment=True``, plain and guarded,
    against the single-device fused steps; a planted fault on rank 1
    sizes the EMA's groups by the rank's blocks, not the whole leaves.
On every case the leaves a spec leaves whole are bitwise equal across the
ranks of those axes, and a second run from the same start is bitwise the
first.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import init_params as ref_init
from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig
from repro_torch.launch.steps import make_guarded_train_step, make_train_step
from repro_torch.models.convert import params_from_jax, reference_leaf_groups

import torch_mesh_workers as W

F32_REL = 1e-5
BF16_LOSS_REL, BF16_GNORM_REL, BF16_UPDATE_REL = 2e-3, 2e-3, 0.5
OPEN_GATE = 0.5
MIXERS = {"minicpm3": ("minicpm3-4b", "mla"), "recurrentgemma": ("recurrentgemma-9b", "rec"),
          "vision": ("llama-3.2-vision-11b", "xattn")}
# This slice's cases: name -> (arch, rules, TrainConfig fields, guarded).
SLICE = {"mamba2": ("mamba2-780m", "DEFAULT_RULES", {}, False),
         "mamba2_small": ("mamba2-780m", "SMALL_MODEL_RULES", {}, False),
         "musicgen": ("musicgen-medium", "DEFAULT_RULES", {}, False),
         "musicgen_small": ("musicgen-medium", "SMALL_MODEL_RULES", {}, False),
         "fused": ("deepseek-7b", "DEFAULT_RULES", {"fused_second_moment": True}, False),
         "fused_guarded": ("deepseek-7b", "DEFAULT_RULES", {"fused_second_moment": True}, True)}
# Each planted fault of this slice -> (the clean case it is held to, the fault).
SLICE_FAULTS = {"ssm": ("mamba2", "ssm"), "books": ("musicgen_small", "books"),
                "ema": ("fused", "ema")}


def _ref_params(arch, dtype):
    cfg = dataclasses.replace(ref_arch(arch, tiny=True), dtype=dtype)
    return jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(3), cfg)[0])


def _tokens(n, rows, seq, seed, vocab=256, books=0):
    """``n`` batches of seeded tokens below ``vocab``: (rows, seq + 1), or
    (rows, seq + 1, books) for an arch with codebook streams."""
    rng = np.random.default_rng(seed)
    shape = (rows, seq + 1) + ((books,) if books else ())
    return [rng.integers(0, vocab, shape).astype(np.int64) for _ in range(n)]


def _case(arch, dtype, kernels, rules, micro, rows=8, seq=32, **kw):
    ref = ref_arch(arch, tiny=True)
    case = dict(arch=arch, dtype=dtype, kernels=kernels, rules=rules, micro=micro,
                params=_ref_params(arch, dtype),
                tokens=_tokens(2, rows, seq, 7, ref.vocab_size, ref.n_codebooks),
                exact_f32=dtype == "float32", **kw)
    if ref.n_img_tokens:  # a cross-attention arch: its context, and its gates open
        rng = np.random.default_rng(9)
        case["ctx"] = [rng.standard_normal((rows, ref.n_img_tokens, ref.d_model))
                       .astype(np.float32) for _ in case["tokens"]]
        case["gate"] = OPEN_GATE
    return case


def _batch(case, i):
    batch = {"tokens": torch.from_numpy(case["tokens"][i])}
    if "ctx" in case:
        batch["image_embeds"] = torch.from_numpy(case["ctx"][i])
    return batch


def _single(case):
    """The port's single-device steps on the whole parameters."""
    from repro_torch.models import attention

    saved = attention.bf16_round
    if case.get("exact_f32"):
        W.exact_f32_attention()
    try:
        cfg = W.sharded_cfg(case["arch"], case["dtype"], case["kernels"])
        tcfg = TrainConfig(microbatches=case["micro"], **case.get("tcfg", {}))
        params = params_from_jax(case["params"], cfg)
        if case.get("gate") is not None:
            W.open_gates(params, cfg, case["gate"])
        for p in R.tree_leaves(params):
            p.requires_grad_(True)
        opt = optim.init_state(params, fused_second_moment=tcfg.fused_second_moment,
                               leaf_groups=reference_leaf_groups(params, cfg))
        metrics = []
        if case.get("guard"):
            step, gstate = make_guarded_train_step(cfg, tcfg), optim.init_guard_state(4)
            for i in range(len(case["tokens"])):
                params, opt, gstate, m = step(params, opt, gstate, _batch(case, i))
                metrics.append({k: float(v) for k, v in m.items()})
        else:
            step = make_train_step(cfg, tcfg)
            for i in range(len(case["tokens"])):
                params, opt, m = step(params, opt, _batch(case, i))
                metrics.append({k: float(v) for k, v in m.items()})
        return metrics, [p.detach() for p in R.tree_leaves(params)]
    finally:
        attention.bf16_round = saved


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _worst_param(whole, single):
    return max(float((w - s).float().norm() / s.float().norm().clamp_min(1e-30))
               for w, s in zip(whole, single))


def _update_gaps(whole, single, start):
    """The two runs' updates, each leaf's after - before in f32: the worst
    ||sharded - single|| / ||single|| over the leaves the single-device
    update moved, and the least that gap would be with the sharded update's
    sign flipped. A leaf the single-device update left alone must be left
    alone (a gap of inf otherwise)."""
    worst, flipped = 0.0, float("inf")
    for w, s, p0 in zip(whole, single, start):
        d_sharded = w.float() - p0.float()
        d_single = s.float() - p0.float()
        ref = float(d_single.norm())
        if ref == 0.0:
            worst = max(worst, 0.0 if float(d_sharded.norm()) == 0.0 else float("inf"))
            continue
        worst = max(worst, float((d_sharded - d_single).norm()) / ref)
        flipped = min(flipped, float((d_sharded + d_single).norm()) / ref)
    return worst, flipped


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a, b) -> bool:
    """Metrics lists equal bit for bit (NaN equal to NaN)."""
    def key(ms):
        return [{k: np.float64(v).tobytes() for k, v in m.items()} for m in ms]
    return key(a) == key(b)


def _bitwise_repeat(ranks):
    for r in ranks:
        first, second = r["runs"][0], r["runs"][1]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first["local"],
                                                                    second["local"]))
        assert _same(first["metrics"], second["metrics"])


def _check(ranks, single, loss_rel, gnorm_rel, param_rel):
    metrics, params = single
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r in ranks:
        for run in r["runs"]:
            assert run["replicas_agree"]
            for got, want in zip(run["metrics"], metrics):
                for k in worst:
                    worst[k] = max(worst[k], _rel(got[k], want[k]))
        assert _same(r["runs"][0]["metrics"], ranks[0]["runs"][0]["metrics"])  # the same bits
    if param_rel is None:
        return worst["loss"] <= loss_rel and worst["grad_norm"] <= gnorm_rel, worst
    worst["param"] = _worst_param(ranks[0]["whole"], params)
    return (worst["loss"] <= loss_rel and worst["grad_norm"] <= gnorm_rel
            and worst["param"] <= param_rel), worst


def _guarded_case():
    case = _case("deepseek-7b", "float32", False, "DEFAULT_RULES", 1, guard=True)
    case["tokens"] = _tokens(3, 8, 32, 11)
    scales = [np.ones(4, np.float32) for _ in range(3)]
    scales[1][2] = np.nan  # rank 2's gradients poisoned on step 2
    case["scales"] = scales
    return case


@pytest.fixture(scope="module")
def f32_cases():
    cases = {
        "deepseek": _case("deepseek-7b", "float32", False, "DEFAULT_RULES", 2),
        "granite": _case("granite-moe-1b-a400m", "float32", False, "SMALL_MODEL_RULES", 2),
        "guarded": _guarded_case(),
    }
    for name, (arch, _) in MIXERS.items():
        cases[name] = _case(arch, "float32", False, "DEFAULT_RULES", 2)
    cases["fault"] = _case("deepseek-7b", "float32", False, "DEFAULT_RULES", 2, fault=True,
                           runs=1)
    for name, (arch, kind) in MIXERS.items():
        cases[f"fault_{kind}"] = _case(arch, "float32", False, "DEFAULT_RULES", 2, fault=kind,
                                       runs=1)
    for name, (arch, rules, tcfg, guard) in SLICE.items():
        cases[name] = _case(arch, "float32", False, rules, 2, tcfg=tcfg, guard=guard)
        if guard:  # no poisoned step: the accepted steps against the single device's
            cases[name]["scales"] = [np.ones(4, np.float32) for _ in cases[name]["tokens"]]
    for kind, (clean, fault) in SLICE_FAULTS.items():
        cases[f"fault_{kind}"] = dict(cases[clean], fault=fault, runs=1)
    return cases


@pytest.fixture(scope="module")
def singles(f32_cases):
    """The single-device steps of the clean cases, made once (a planted
    fault's case has its clean case's weights and batches)."""
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _single(f32_cases[name])
        return memo[name]

    return get


@pytest.fixture(scope="module")
def ranks_2x2(tmp_path_factory, f32_cases):
    """Every f32 case on one spawn of (2, 2), the planted faults last. Its
    deadline (a hang's, no limit on the result) is twice a spawn's: the
    cases take ~80 s alone and 280 s beside the whole suite on 8 cores."""
    ranks = W.run_mesh("sharded_cases", (2, 2), ("data", "model"),
                       tmp_path_factory.mktemp("sharded"), f32_cases,
                       timeout=2 * W.SPAWN_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in f32_cases}


@pytest.mark.parametrize("name", ["deepseek", "granite", "minicpm3", "recurrentgemma",
                                  "vision"] + list(SLICE))
def test_f32_sharded_step_holds_the_single_device_step(ranks_2x2, singles, name):
    ok, worst = _check(ranks_2x2[name], singles(name), F32_REL, F32_REL, F32_REL)
    assert ok, worst
    _bitwise_repeat(ranks_2x2[name])


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_planted_mixer_fault_fails_the_limit_and_the_replicas(ranks_2x2, singles, name):
    """One mixer's f or g planted wrong on rank 1 (the module doc): the
    sharded step leaves the limit, and the leaves its spec leaves whole
    (kv_down before MLA's RoPE key, the norms before the RG-LRU and the
    cross-attention) no longer agree across the model ranks."""
    ranks = ranks_2x2[f"fault_{MIXERS[name][1]}"]
    ok, worst = _check_gaps(ranks, singles(name))
    print(f"planted {MIXERS[name][1]} fault: worst relative gaps {worst}")
    assert max(worst.values()) > F32_REL
    assert not all(r["runs"][0]["replicas_agree"] for r in ranks)


def _check_gaps(ranks, single):
    """The worst relative gaps of every rank's first run against the
    single-device step: loss, grad norm, and every parameter."""
    metrics, params = single
    worst = {k: max(_rel(got[k], want[k]) for r in ranks
                    for got, want in zip(r["runs"][0]["metrics"], metrics))
             for k in ("loss", "grad_norm")}
    worst["param"] = _worst_param(ranks[0]["whole"], params)
    return max(worst.values()) <= F32_REL, worst


@pytest.mark.parametrize("kind", sorted(SLICE_FAULTS))
def test_planted_slice_fault_fails_the_limit(ranks_2x2, singles, f32_cases, kind):
    """This slice's planted faults on rank 1 (the module doc): the gated
    norm's statistic summed forward only, the codebook lookup's offset
    from ``Plan.vocab0``, the fused EMA's group sizes from the rank's
    blocks. Each leaves the 1e-5 limit against the single-device step.
    The EMA's fault moves the update alone (the loss and the norm are the
    clean step's, and the warmup's small learning rate keeps the weights
    near their start), so its two steps' update (after - before) must
    also sit over 100 times further from the single device's than the
    clean fused case's does."""
    clean, _ = SLICE_FAULTS[kind]
    ranks = ranks_2x2[f"fault_{kind}"]
    ok, worst = _check_gaps(ranks, singles(clean))
    print(f"planted {kind} fault: worst relative gaps {worst}")
    assert max(worst.values()) > F32_REL
    if kind == "ema":
        cfg = W.sharded_cfg("deepseek-7b", "float32", False)
        start = [p.detach() for p in R.tree_leaves(params_from_jax(
            f32_cases[clean]["params"], cfg))]
        single = singles(clean)[1]
        gap, _ = _update_gaps(ranks[0]["whole"], single, start)
        clean_gap, _ = _update_gaps(ranks_2x2[clean][0]["whole"], single, start)
        print(f"planted ema fault: update gap {gap:.4g}, the clean case's {clean_gap:.4g}")
        assert gap > 100 * clean_gap


def test_planted_fault_fails_the_limit(ranks_2x2, singles):
    """Rank 1's Megatron all-reduce 2^-10 too large: the sharded step
    leaves the limit (the merged loss and the combined norm stay the same
    on every rank, so the gap shows against the single-device step)."""
    ranks = ranks_2x2["fault"]
    metrics, params = singles("deepseek")
    firsts = [r["runs"][0]["metrics"] for r in ranks]
    worst = max(_rel(got[k], want[k]) for run in firsts for got, want in zip(run, metrics)
                for k in ("loss", "grad_norm"))
    worst = max(worst, _worst_param(ranks[0]["whole"], params))
    print(f"planted fault: worst relative gap {worst:.3g}")
    assert worst > F32_REL


def test_internlm2_bf16_on_2x4(tmp_path):
    case = _case("internlm2-1.8b", "bfloat16", True, "DEFAULT_RULES", 2,
                 tcfg={"warmup_steps": 1})
    ranks = W.run_mesh("sharded_train", (2, 4), ("data", "model"), tmp_path, case)
    single = _single(case)
    ok, worst = _check(ranks, single, BF16_LOSS_REL, BF16_GNORM_REL, None)
    assert ok, worst
    cfg = W.sharded_cfg(case["arch"], case["dtype"], case["kernels"])
    start = [p.detach() for p in R.tree_leaves(params_from_jax(case["params"], cfg))]
    gap, flipped = _update_gaps(ranks[0]["whole"], single[1], start)
    assert gap <= BF16_UPDATE_REL < flipped, (gap, flipped)
    _bitwise_repeat(ranks)


def test_guarded_sharded_step_skips_in_lockstep(ranks_2x2, f32_cases):
    case, ranks = f32_cases["guarded"], ranks_2x2["guarded"]
    for r in ranks:
        run = r["runs"][0]
        assert [m["skipped"] for m in run["metrics"]] == [0.0, 1.0, 0.0]
        assert run["replicas_agree"]
        before, after = run["bits_after"][0], run["bits_after"][1]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(before, after))
        assert r["guard"] == ranks[0]["guard"] == {"skipped": 1, "filled": 2}
        assert _same(run["metrics"], ranks[0]["runs"][0]["metrics"])
    _bitwise_repeat(ranks)
    # the accepted steps hold the single-device guarded step on the same
    # batches with step 2 skipped
    single_case = dict(case, tokens=[case["tokens"][0], case["tokens"][2]])
    metrics, params = _single(single_case)
    got = ranks[0]["runs"][0]["metrics"]
    for g, m in zip([got[0], got[2]], metrics):
        assert _rel(g["loss"], m["loss"]) <= F32_REL
        assert _rel(g["grad_norm"], m["grad_norm"]) <= F32_REL
    assert _worst_param(ranks[0]["whole"], params) <= F32_REL


def _plan(cfg, shape, rules="DEFAULT_RULES", rank=0):
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.model import init_params, param_axes
    from repro_torch.models.parallel import Plan

    mesh = dataclasses.replace(abstract_mesh(shape, ("data", "model")), rank=rank)
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    return Plan(cfg, mesh, SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta))


@pytest.mark.parametrize("what", ["gate_blocks", "ssm_heads"])
def test_plan_refuses_the_cuts_a_mixer_cannot_run(what):
    """An RG-LRU whose rank's channels are no whole gate blocks (64
    channels over 32 model ranks: 2 a rank, gate blocks of 4, which the
    rules leave whole), and an SSM whose rank's channels are no whole
    heads (tiny mamba2's 128 over 16 model ranks: 8 a rank, heads of
    16)."""
    from repro_torch.configs import get_arch

    if what == "gate_blocks":
        cfg, shape, match = get_arch("recurrentgemma-9b", tiny=True), (1, 32), "whole gate blocks"
    else:
        cfg, shape, match = get_arch("mamba2-780m", tiny=True), (1, 16), "not whole heads of 16"
    with pytest.raises(NotImplementedError, match=match):
        _plan(cfg, shape)


# name -> (arch, tiny, config overrides, mesh, cache slots, the model ranks'
# head blocks, q_up / kv_up / o: "gather" or "whole")
UNEVEN = {
    "tiny_1x8": ("minicpm3-4b", True, {}, (1, 8), 16,
                 [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3), (3, 4)],
                 ("gather", "gather", "gather")),
    "tiny_heads3_2x2": ("minicpm3-4b", True, {"n_heads": 3, "n_kv_heads": 3}, (2, 2), 16,
                        [(0, 1), (1, 3)], ("gather", "gather", "gather")),
    "tiny_1x3": ("minicpm3-4b", True, {}, (1, 3), 12, [(0, 1), (1, 2), (2, 4)],
                 ("gather", "whole", "whole")),
    "full_1x3": ("minicpm3-4b", False, {}, (1, 3), 270, [(0, 13), (13, 26), (26, 40)],
                 ("gather", "whole", "whole")),
    "full_16x16": ("minicpm3-4b", False, {}, (16, 16), 32,
                   [(m * 40 // 16, (m + 1) * 40 // 16) for m in range(16)],
                   ("gather", "gather", "gather")),
}


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_plan_takes_mla_heads_a_model_axis_does_not_divide(name):
    """MLA's query heads over a model axis they do not divide: each model
    rank's block of the heads (m H / P to (m + 1) H / P: 40 over 16 gives
    2, 3, 2, 3, ...; 4 over 8 leaves every other rank none), the head
    leaves cut inside a head gathered over "model" and those the rules
    leave whole (5120 and 2560 over 3 ranks) used whole, on every block;
    the serving layout's latent cut by slots and every rank's head count
    for the decode's padded q gather."""
    from repro_torch.configs import get_arch
    from repro_torch.models import make_caches

    arch, tiny, over, shape, s_max, blocks, modes = UNEVEN[name]
    cfg = dataclasses.replace(get_arch(arch, tiny=tiny), **over)
    n_model = shape[1]
    plan = _plan(cfg, shape)
    assert plan._blocks(cfg.n_heads) == blocks
    for m in (1, n_model - 1):  # a model rank's own block
        assert _plan(cfg, shape, rank=m)._block(cfg.n_heads, True) == blocks[m]
    want = dict(zip(("q_up", "kv_up", "o"), modes))
    for kind, sp in zip(cfg.pattern_layers, plan.specs["layers"]):
        lay = plan.layout(sp, kind)
        assert lay["attn_tp"] and lay["mla"] == want, kind
    plan = plan.for_caches(make_caches(cfg, 16, s_max, torch.device("meta")))
    for i in range(cfg.n_layers):
        lay = plan.serve_layout(i)
        assert lay["cache"] == "seq" and lay["slots"] == (0, s_max // n_model)
        assert lay["q_heads"] == blocks[0]
        assert lay["q_sizes"] == tuple(b - a for a, b in blocks)


@pytest.mark.parametrize("arch", ["mamba2-780m", "musicgen-medium"])
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "SMALL_MODEL_RULES"])
def test_plan_takes_ssm_blocks_and_codebook_streams(arch, rules):
    """The training plan takes the SSM and the codebook streams on (2, 2):
    the SSM's channels split over "model" (``inner_tp``) as the rules cut
    "inner" (DEFAULT_RULES) and whole under SMALL_MODEL_RULES; the
    vocabulary cut over "model" under both, the codebook table's rows from
    its own block start (32 on rank 1 of tiny musicgen's 64), the head's
    columns from the padded vocabulary's (128 of 256). The serving layout
    of the same plan takes every block: the SSM's state cut by heads and
    its conv cache by channels, the heads' y gathered where the weights
    are whole; the codebook arch's k/v caches by kv heads."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import make_caches
    from repro_torch.models.model import init_params, param_axes
    from repro_torch.models.parallel import Plan

    cfg = get_arch(arch, tiny=True)
    plan = _plan(cfg, (2, 2), rules)
    assert plan.vocab_parallel
    for kind, sp in zip(cfg.pattern_layers, plan.specs["layers"]):
        lay = plan.layout(sp, kind)
        tp = lay["inner_tp" if kind == "ssm" else "attn_tp"]
        assert tp == (rules == "DEFAULT_RULES"), kind
    mesh = dataclasses.replace(abstract_mesh((2, 2), ("data", "model")), rank=1)  # model 1
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    rank1 = Plan(cfg, mesh, SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta))
    assert rank1.vocab0 == 128
    assert rank1.book0 == (32 if cfg.n_codebooks else 128)
    plan = plan.for_caches(make_caches(cfg, 2, 16, torch.device("meta")))
    for i, kind in enumerate(cfg.pattern_layers):
        lay = plan.serve_layout(i)
        if kind == "ssm":  # 8 heads and 160 conv channels of [x, B, C] over 2 ranks
            assert (lay["cache"], lay["q_heads"], lay["channels"]) == ("channels", (0, 4),
                                                                      (0, 80))
            assert lay["gather_heads"] == (rules == "SMALL_MODEL_RULES")
        else:
            assert (lay["cache"], lay["cache_heads"]) == ("heads", (0, 2))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b", "llama-3.2-vision-11b"])
def test_plan_takes_the_mixers_and_the_serving_layout_refuses_them(arch):
    """The training plan of each new mixer on (2, 2), its layout's TP as
    the rules cut it; the serving layout of the same plan takes each
    block: MLA's latent and the one-kv-head ring cut by slots, the
    RG-LRU's channels and the cross-attention cache by kv heads, each
    rank on its half of the heads or channels."""
    from repro_torch.configs import get_arch
    from repro_torch.models import make_caches

    cfg = get_arch(arch, tiny=True)
    plan = _plan(cfg, (2, 2))
    for kind, sp in zip(cfg.pattern_layers, plan.specs["layers"]):
        lay = plan.layout(sp, kind)
        assert lay["inner_tp" if kind == "rec" else "attn_tp"], kind
    plan = plan.for_caches(make_caches(cfg, 2, 16, torch.device("meta")))
    for i, kind in enumerate(cfg.pattern_layers):
        lay = plan.serve_layout(i)
        if kind == "rec":  # 64 channels, 16 gate blocks of 4, over 2 ranks
            assert (lay["cache"], lay["channels"], lay["gather_heads"]) == ("channels", (0, 32),
                                                                           False)
        elif kind == "local_attn":  # one kv head: the ring of 16 slots cut by slots
            assert (lay["cache"], lay["slots"], lay["q_heads"]) == ("seq", (0, 8), (0, 2))
        elif kind == "xattn" or cfg.mla is None:  # two kv heads: one a rank
            assert (lay["cache"], lay["cache_heads"], lay["q_heads"]) == ("heads", (0, 1),
                                                                         (0, 2))
        else:  # MLA's latent cut by slots
            assert (lay["cache"], lay["slots"], lay["q_heads"]) == ("seq", (0, 8), (0, 2))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("guarded", [False, True])
def test_adamw_in_pieces_is_bitwise_the_whole_leaf(guarded, fused):
    """The sharded step's AdamW runs a leaf past ``SHARDED_PIECE`` elements
    in pieces (so that ranks sharing a card hold one piece's f32
    temporaries): two steps in pieces of 7 are bitwise two whole-leaf
    steps, plain and guarded (a clean step and a skipped one), with the
    elementwise second moment and the fused one."""
    from repro_torch.optim import adamw

    tcfg = TrainConfig(warmup_steps=1)
    runs = []
    for piece in (None, 7):
        gen = torch.Generator().manual_seed(0)
        params = [torch.randn(5, 9, generator=gen), torch.randn(3, generator=gen).bfloat16(),
                  torch.randn(100, 33, generator=gen)]
        grads = [torch.randn(p.shape, generator=gen).to(p.dtype) for p in params]
        per_leaf = torch.stack([g.float().square().sum() for g in grads])
        state = optim.init_state(params, fused_second_moment=fused)
        for keep in ((torch.tensor(False), torch.tensor(True)) if guarded else (None, None)):
            state, _ = adamw._adamw_core(params, grads, state, tcfg, clip=torch.tensor(0.7),
                                         per_leaf=per_leaf, fused_second_moment=fused,
                                         keep=keep, piece=piece)
        runs.append([_bits(t) for t in params + state.m + state.v])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
