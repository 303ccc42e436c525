"""MLA's query heads over a model axis they do not divide.

The reference runs minicpm3-4b's 40 heads over 16 model ranks (GSPMD cuts
q_up's, kv_up's and o's flattened head dims wherever they divide); the
port runs each rank's block of the heads, 2 or 3 of them, with the head
leaves cut inside a head gathered over "model" and cut to those heads
(``models.parallel``'s module doc, ``Plan.layout``'s ``mla`` key). Two
tiny minicpm3 cases, each on one spawn of gloo CPU ranks
(``torch_mesh_workers.train_and_serve``), weights from the JAX package's
``init_params`` carried across:

  * ``heads3`` -- 3 heads (and kv heads) on (data 2, model 2), 1 and 2
    heads a rank: q_up's 72 columns, kv_up's 96 and o's 48 rows are all
    cut inside a head and gathered, the production mesh's pattern;
  * ``tiny_1x3`` -- the config's 4 heads on (data 1, model 3), 1, 1 and 2
    heads a rank: q_up's 96 columns alone are cut (32 a rank, inside a
    head), kv_up's 128 and o's 64 stay whole, the card's pattern.

Each trains 2 steps of two microbatches (DEFAULT_RULES) and serves 4
prompts plus 4 teacher-forced decode steps (TP_ONLY_RULES) with the
latent cut by slots, so the decode gathers q_c and q_rope in blocks of
unequal sizes. Against the port's single-device steps on the same weights
and batches, at f32 with the attention's bf16 operand rounding off
(``exact_f32_attention``, as ``tests/test_torch_sharded_step.py`` and
``tests/test_torch_sharded_serving.py`` hold theirs, for the reason they
give): loss, grad norm and every parameter within 1e-5 relative; the
prefill's logits and caches and every decode step's logits within 1e-5
(max |sharded - single| over max |single|); the greedy tokens equal the
single device's argmax. The leaves a spec leaves whole are bitwise equal
across the ranks that hold them, a second run is bitwise the first, and
a retried decode step bitwise the clean one. A planted fault on global
rank 1, o cut one head below its own block of rows
(``torch_mesh_workers._plant_o_rows``), must leave both limits by at
least 10 times. The serving dry run (``serve_collectives``,
``serve_rank_bytes``) equals the metered runs byte for byte; the training
one is held in ``tests/test_torch_dryrun.py``.

The 3-head config's single-device forward holds the reference's on the
same weights within ``tests/harness.py``'s budget for bf16 multipliers
(``COMPUTE_REL["bfloat16"]`` of the largest logit): both round the
attention's operands to bf16 at the same points.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import COMPUTE_REL
from repro.configs import get_arch as ref_arch
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro_torch import models, optim
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import attention
from repro_torch.models.convert import params_from_jax, reference_leaf_groups
from repro_torch.models.model import init_params, param_axes

import torch_mesh_workers as W

ARCH = "minicpm3-4b"
REL, FAULT_X = 1e-5, 10
AXES = ("data", "model")
# name -> (mesh, config overrides, serving prompt length, cache slots)
MESHES = {"heads3": ((2, 2), {"n_heads": 3, "n_kv_heads": 3}, 8, 16),
          "tiny_1x3": ((1, 3), {}, 8, 12)}
ROWS, SEQ, MICRO, STEPS, SLOTS = 8, 32, 2, 4, 4


def _ref_params(over: dict):
    cfg = dataclasses.replace(ref_arch(ARCH, tiny=True), dtype="float32", **over)
    return jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(3), cfg)[0])


def _cases(name: str):
    """The mesh's training and serving cases, each clean and with the
    planted fault."""
    _, over, prompt, s_max = MESHES[name]
    params, rng = _ref_params(over), np.random.default_rng(7)
    train = dict(arch=ARCH, dtype="float32", kernels=False, rules="DEFAULT_RULES", micro=MICRO,
                 cfg=over, params=params, exact_f32=True, meter=True,
                 tokens=[rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int64)
                         for _ in range(2)])
    serve = dict(arch=ARCH, rules="TP_ONLY_RULES", cfg=over, params=params, s_max=s_max,
                 prompts=rng.integers(0, 256, (SLOTS, prompt)).astype(np.int64),
                 decode=[rng.integers(0, 256, (SLOTS, 1)).astype(np.int64)
                         for _ in range(STEPS)], runs=2, meter=True)
    return ({"clean": train, "fault": dict(train, fault="o_rows", runs=1, meter=False)},
            {"clean": serve, "fault": dict(serve, fault="o_rows", runs=1, meter=False)})


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, tmp_path_factory):
    """(name, the cases, what every rank returned) of one mesh's spawn."""
    name = request.param
    train, serve = _cases(name)
    ranks = W.run_mesh("train_and_serve", MESHES[name][0], AXES,
                       tmp_path_factory.mktemp(f"uneven_{name}"), train, serve)
    return name, train, serve, ranks


def _cfg(case):
    return dataclasses.replace(W.sharded_cfg(ARCH, "float32", False), **case["cfg"])


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _single_train(case):
    """The port's single-device steps on the whole weights: each step's
    metrics and the parameters after."""
    saved = attention.bf16_round
    W.exact_f32_attention()
    try:
        cfg = _cfg(case)
        params = params_from_jax(case["params"], cfg)
        for p in R.tree_leaves(params):
            p.requires_grad_(True)
        opt = optim.init_state(params, leaf_groups=reference_leaf_groups(params, cfg))
        step = make_train_step(cfg, TrainConfig(microbatches=case["micro"]))
        metrics = []
        for tok in case["tokens"]:
            params, opt, m = step(params, opt, {"tokens": torch.from_numpy(tok)})
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, [p.detach() for p in R.tree_leaves(params)]
    finally:
        attention.bf16_round = saved


def _train_gaps(ranks, single) -> dict:
    metrics, params = single
    worst = {k: max(_rel(got[k], want[k]) for r in ranks for run in r["runs"]
                    for got, want in zip(run["metrics"], metrics)) for k in ("loss", "grad_norm")}
    worst["param"] = max(_rel(w, s) for w, s in zip(ranks[0]["whole"], params))
    return worst


def _single_serve(case) -> dict:
    saved = attention.bf16_round
    W.exact_f32_attention()
    try:
        cfg = W.serving_cfg(case)
        params = params_from_jax(case["params"], cfg)
        decode = make_decode_step(cfg, greedy=False)
        with torch.inference_mode():
            logits, caches = make_prefill_step(cfg, case["s_max"])(
                params, torch.from_numpy(case["prompts"]))
            out = {"prefill": logits, "caches": [t.clone() for t in R.tree_leaves(caches)],
                   "steps": []}
            pos = case["prompts"].shape[1]
            for tok in case["decode"]:
                lg, caches = decode(params, caches, torch.from_numpy(tok), pos)
                out["steps"].append(lg)
                pos += 1
        return out
    finally:
        attention.bf16_round = saved


def _rows(name: str, r: int) -> slice:
    """Global rank r's rows of the serving batch: its data group's block."""
    data, model = MESHES[name][0]
    d = r // model
    return slice(d * SLOTS // data, (d + 1) * SLOTS // data)


def _serve_gaps(name, ranks, single) -> dict:
    worst = {"prefill": 0.0, "caches": 0.0, "steps": 0.0}
    for r, res in enumerate(ranks):
        rows = _rows(name, r)
        for run in res["runs"]:
            worst["prefill"] = max(worst["prefill"], _rel(run["prefill"], single["prefill"][rows]))
            for got, want in zip(run["caches"], single["caches"]):
                if got.is_floating_point():
                    worst["caches"] = max(worst["caches"], _rel(got, want))
                else:  # the slot positions, whole on every rank
                    assert torch.equal(got, want)
            for step, want in zip(run["steps"], single["steps"]):
                worst["steps"] = max(worst["steps"], _rel(step["logits"], want[rows]))
    return worst


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_sharded_step_holds_the_single_device_step(mesh_run):
    name, train, _, ranks = mesh_run
    got = [r["train"]["clean"] for r in ranks]
    worst = _train_gaps(got, _single_train(train["clean"]))
    print(f"{name}: worst relative gaps {worst}")
    assert max(worst.values()) <= REL, worst
    for res in got:
        first, second = res["runs"]
        assert first["replicas_agree"] and second["replicas_agree"]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first["local"],
                                                                    second["local"]))
        assert first["metrics"] == second["metrics"] == got[0]["runs"][0]["metrics"]


def test_planted_o_rows_fail_the_training_limit(mesh_run):
    name, train, _, ranks = mesh_run
    worst = _train_gaps([r["train"]["fault"] for r in ranks], _single_train(train["clean"]))
    print(f"{name}, o one head off on rank 1: worst relative gaps {worst}")
    assert max(worst.values()) >= FAULT_X * REL, worst


def test_sharded_serving_holds_the_single_device_steps(mesh_run):
    name, _, serve, ranks = mesh_run
    single = _single_serve(serve["clean"])
    got = [r["serve"]["clean"] for r in ranks]
    worst = _serve_gaps(name, got, single)
    print(f"{name}: worst relative gaps {worst}")
    assert max(worst.values()) <= REL, worst
    for r, res in enumerate(got):
        runs = res["runs"]
        for run in runs:
            assert run["retry_bitwise"] and run["retry_wrote"] and run["replicas_agree"]
        assert W._same_bits(runs[0]["prefill"], runs[1]["prefill"])
        assert W._same_bits(runs[0]["caches"], runs[1]["caches"])
        assert all(W._same_bits(a, b) for a, b in zip(runs[0]["steps"], runs[1]["steps"]))
        for step, want in zip(runs[0]["steps"], single["steps"]):
            assert torch.equal(step["token"],
                               torch.argmax(want[_rows(name, r)], -1).to(torch.int32))


def test_planted_o_rows_fail_the_serving_limit(mesh_run):
    name, _, serve, ranks = mesh_run
    worst = _serve_gaps(name, [r["serve"]["fault"] for r in ranks],
                        _single_serve(serve["clean"]))
    print(f"{name}, o one head off on rank 1: worst relative gaps {worst}")
    assert max(worst.values()) >= FAULT_X * REL, worst


def test_serving_dry_run_equals_the_metered_run(mesh_run):
    """``serve_collectives`` of the prefill and of a decode step (greedy
    and not), the gathered head leaves and the padded q gather in them,
    equal the noted traffic by kind and axis and the c10d all-gathers'
    bytes; ``serve_rank_bytes``' blocks equal the allocated ones."""
    name, _, serve, ranks = mesh_run
    case = serve["clean"]
    cfg = W.serving_cfg(case)
    mesh = abstract_mesh(MESHES[name][0], AXES)
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, SH.TP_ONLY_RULES, meta)
    prompt = case["prompts"].shape[1]
    for mode, greedy in (("prefill", False), ("decode", False), ("decode", True)):
        model = dryrun.serve_collectives(cfg, mesh, specs, mode, SLOTS,
                                         prompt if mode == "prefill" else case["s_max"],
                                         greedy=greedy, s_max=case["s_max"])
        want = collections.Counter()
        for (kind, ax, _), b in model.items():
            want[(kind, ax)] += b
        key = "greedy" if greedy else mode
        for r in ranks:
            res = r["serve"]["clean"]
            noted = collections.Counter()
            for kind, ax, b in res[f"{key}_traffic"]:
                noted[(kind, ax)] += b
            assert noted == want, key
            assert sum(out - inb for op, inb, out in res[f"{key}_c10d"]
                       if op.startswith("allgather") or op == "_allgather_base_") \
                == sum(model.values()), key
    want = dryrun.serve_rank_bytes(cfg, mesh, specs, "prefill", SLOTS, prompt,
                                   s_max=case["s_max"])
    for r in ranks:
        for k in ("params", "caches", "logits"):
            assert r["serve"]["clean"]["block_bytes"][k] == want[k], k


def test_three_head_forward_holds_the_reference():
    over = MESHES["heads3"][1]
    rcfg = dataclasses.replace(ref_arch(ARCH, tiny=True), use_pallas=False,
                               mma_reductions=False, **over)
    pcfg = dataclasses.replace(W.sharded_cfg(ARCH, "float32", False), **over)
    rparams, _ = ref_init(jax.random.PRNGKey(3), rcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(ref_forward(rparams, rcfg, jnp.asarray(tokens))[0])
    with torch.no_grad():
        got = models.forward(pparams, pcfg, torch.from_numpy(tokens).long())[0].numpy()
    assert got.shape == want.shape == (2, 24, pcfg.vocab_size)
    tol = COMPUTE_REL["bfloat16"] * float(np.abs(want).max())
    print(f"3-head forward: max |port - reference| {np.abs(got - want).max():.3g} (tol {tol:.3g})")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_a_rank_with_no_heads_gives_zeros():
    """A model rank whose block of the query heads is empty (tiny
    minicpm3's 4 heads over 8 ranks) gives zeros to Megatron's g in the
    train step and the decode, and its backward still reaches the
    latents, which every rank's f sums."""
    from repro_torch.models import mla

    cfg = W.sharded_cfg(ARCH, "float32", False)
    p = mla.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    for name, dim in (("q_up", 1), ("kv_up", 1), ("o", 0)):
        p[name] = {"w": p[name]["w"].narrow(dim, 0, 0).clone()}
    for t in R.tree_leaves(p):
        t.requires_grad_(True)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    pos = torch.arange(5).expand(2, 5)
    y = mla.mla_train(p, x, pos, cfg)
    y.sum().backward()
    assert y.shape == x.shape and not y.detach().any()
    assert x.grad is not None and not x.grad.any()
    assert p["q_down"]["w"].grad is not None and p["kv_down"]["w"].grad is not None
    cache = mla.make_mla_cache(2, 8, cfg, torch.float32, "cpu")
    with torch.no_grad():
        mla.mla_fill_cache(p, x, pos, cache, cfg)
        out, cache = mla.mla_decode(p, x[:, :1], cache, 5, cfg)
    assert out.shape == (2, 1, cfg.d_model) and not out.any()
