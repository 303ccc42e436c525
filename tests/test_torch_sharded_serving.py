"""The sharded serving steps against the single-device steps.

One spawn of four gloo CPU ranks on (data 2, model 2) runs every case
(``tests/torch_serving_cases.py``: TP with heads cut, SMALL_MODEL_RULES'
whole weights with caches cut by heads, EP, the split-KV merge of caches
cut by sequence, FSDP under BIG_MODEL_RULES; MLA's latent cut by slots,
the SSM's state by heads and its conv cache by channels, the RG-LRU's
channels and a local attention's ring cut by slots, cross-attention cut
by kv heads and by image tokens, the codebook streams; and the planted
faults), each twice from the same start, plus the greedy merge on planted
rows and ``launch.train.build(mesh=)``. Each rank gets the global batch
of seeded numpy prompts (and a cross-attention arch's context) and the
same teacher-forced decode tokens.

  * The sharded prefill's last-token logits and its caches (gathered
    whole) match the port's single-device prefill, and the next 4 decode
    steps' logits match the single-device decode, within 1e-5 relative
    (max |sharded - single| over max |single|, a tensor at a time). The
    cases run at f32 on the non-kernel route with the attention's bf16
    operand rounding off in both (``exact_f32_attention``): the rounding
    would turn a last-bit difference of a product taken over a rank's
    columns or heads into a bf16 ulp (~4e-3), where the sharding's own
    agreement reads ~1e-6 (the row-parallel partial sums and the
    split-KV merge add in other orders than the whole products; MLA's
    latent merge divides once where one device normalises every weight).
    With the rounding on, MLA's merge could round only the unnormalised
    weights where one device rounds the normalised ones: the two would
    part by bf16's error, which is why the f32 limit is held with it off.
    The greedy tokens equal ``torch.argmax`` of the single-device logits
    (per codebook stream).
  * The single-device steps (the operand rounding on, as the reference's)
    hold the JAX package's ``make_prefill_step`` and ``make_decode_step``
    on the same weights within 0.01 absolute on the logits, the MoE archs'
    limit of ``tests/test_torch_dense_archs.py``, for every case: at f32
    the two sides differ where an f32 sum a few ulps apart flips one bf16
    rounding of an attention operand (2^-8 of it), and later positions
    carry that step (``tests/test_torch_nonkernel_route.py`` observed 1.6e-3
    on olmo's logits). Here internlm2's one-kv-head case reads 1.1e-3 in
    the prefill and 5.3e-3 in two of 1024 decode logits; the other cases
    under 1e-4.
  * The greedy merge equals ``torch.argmax`` on planted ties and NaNs.
  * A retried sharded decode step equals the clean one bit for bit, its
    caches included; two runs, and the outputs every rank of an axis
    holds alike (the logits and tokens over "model", the caches over the
    axes their spec leaves whole), are equal bit for bit.
  * Each planted fault (``torch_serving_cases.FAULTS``) fails its check:
    a logit fault the 1e-5 limit by at least 10 times, the greedy merge's
    fault the tokens' equality.
  * The ring cache cut by slots wrapped over the cut: after the prefill,
    each model rank's slots hold a position past the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro_torch import reduce as R
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention
from repro_torch.models.convert import params_from_jax

import dataclasses

import torch_mesh_workers as W
import torch_serving_cases as SC

REL = 1e-5
REF_ATOL = 0.01
FAULT_X = 10  # a planted logit fault reads at least this many times REL


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    return SC.serving_ranks(request, tmp_path_factory)


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _single(case, exact: bool = True) -> dict:
    """The port's single-device prefill and decode steps on the whole
    weights: the prefill's logits and caches, each step's logits."""
    saved = attention.bf16_round
    if exact:
        W.exact_f32_attention()
    try:
        cfg = W.serving_cfg(case)
        params = params_from_jax(case["params"], cfg)
        decode = make_decode_step(cfg, greedy=False)
        ctx = torch.from_numpy(case["ctx"]) if "ctx" in case else None
        with torch.inference_mode():
            logits, caches = make_prefill_step(cfg, case["s_max"])(
                params, torch.from_numpy(case["prompts"]), ctx)
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


def _rows(r: int, batch: int) -> slice:
    """Rank r's rows of a (data 2, model 2) mesh: its data group's half, or
    every row where the batch does not split."""
    if batch % 2:
        return slice(0, batch)
    d = r // 2
    return slice(d * batch // 2, (d + 1) * batch // 2)


def _worst(ranks, single, batch) -> dict:
    worst = {"prefill": 0.0, "caches": 0.0, "steps": 0.0}
    for r, res in enumerate(ranks):
        rows = _rows(r, batch)
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


@pytest.mark.parametrize("name", SC.CASES)
def test_sharded_serving_holds_the_single_device_steps(ranks, name):
    case = SC.case(name)
    single = _single(case)
    worst = _worst([r[name] for r in ranks], single, case["prompts"].shape[0])
    print(f"{name}: worst relative gaps {worst}")
    assert max(worst.values()) <= REL, worst
    for r, res in enumerate(ranks):
        rows = _rows(r, case["prompts"].shape[0])
        for step, want in zip(res[name]["runs"][0]["steps"], single["steps"]):
            assert torch.equal(step["token"], torch.argmax(want[rows], -1).to(torch.int32))


@pytest.mark.parametrize("name", SC.CASES)
def test_single_device_serving_holds_the_reference(name):
    """The port's single-device steps (the attention's operand rounding on,
    as the reference's) against the JAX package's on the same weights."""
    case = SC.case(name)
    got = _single(case, exact=False)
    rcfg = dataclasses.replace(ref_arch(case["arch"], tiny=True), dtype="float32",
                               mma_reductions=False, **case["cfg"])
    params = jax.tree.map(jnp.asarray, case["params"])
    ctx = jnp.asarray(case["ctx"]) if "ctx" in case else None
    logits, caches = jax.jit(ref_prefill_step(rcfg, case["s_max"]))(
        params, jnp.asarray(case["prompts"], jnp.int32), ctx)
    np.testing.assert_allclose(got["prefill"].numpy(), np.asarray(logits), rtol=0, atol=REF_ATOL)
    decode = jax.jit(ref_decode_step(rcfg, greedy=False))
    pos = case["prompts"].shape[1]
    for tok, mine in zip(case["decode"], got["steps"]):
        want, caches = decode(params, caches, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32), ctx)
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=0, atol=REF_ATOL)
        pos += 1


def test_greedy_merge_is_argmax_on_planted_ties_and_nans(ranks):
    want = torch.argmax(torch.from_numpy(SC.planted_rows())[..., :SC.VOCAB_WITH_PAD], -1)
    assert want.flatten().tolist()[:4] == [10, 130, 150, 5]
    for res in ranks:
        got = res["greedy_planted"]
        assert torch.equal(got["argmax"], want.to(torch.int32))
        assert torch.equal(got["merged"], want.to(torch.int32))


@pytest.mark.parametrize("name", SC.CASES)
def test_retried_decode_step_and_repeats_are_bitwise(ranks, name):
    for res in ranks:
        runs = res[name]["runs"]
        for run in runs:
            assert run["retry_bitwise"] and run["retry_wrote"]
            assert run["replicas_agree"]
        assert W._same_bits(runs[0]["prefill"], runs[1]["prefill"])
        assert W._same_bits(runs[0]["caches"], runs[1]["caches"])
        assert all(W._same_bits(a, b) for a, b in zip(runs[0]["steps"], runs[1]["steps"]))


@pytest.mark.parametrize("fault", sorted(SC.FAULTS))
def test_planted_fault_fails_the_limit(ranks, fault):
    """A logit fault reads at least ``FAULT_X`` times the limit; the greedy
    merge's fault (its logits untouched) gives a token off the argmax."""
    on, kind = SC.FAULTS[fault]
    case = SC.case(on)
    single = _single(case)
    batch = case["prompts"].shape[0]
    got = [r[fault] for r in ranks]
    if kind == "books":
        misses = 0
        for r, res in enumerate(got):
            rows = _rows(r, batch)
            for step, want in zip(res["runs"][0]["steps"], single["steps"]):
                misses += int((step["token"] != torch.argmax(want[rows], -1)).sum())
        print(f"{fault}: {misses} greedy tokens off the argmax")
        assert misses > 0
        return
    worst = _worst(got, single, batch)
    print(f"{fault}: worst relative gaps {worst}")
    assert max(worst.values()) >= FAULT_X * REL, worst


def test_ring_cache_wrapped_over_the_cut(ranks):
    """The rg case's ring (16 slots, 8 a model rank) after a prompt of 28:
    each model rank's slots hold a position past the window, so the
    prefill's writes wrapped across the cut; the sharded caches held the
    single device's (``test_sharded_serving_holds_the_single_device_steps``)."""
    case = SC.case("rg")
    window = W.serving_cfg(case).window
    assert case["prompts"].shape[1] > window
    for res in ranks:
        rings = [t for t in res["rg"]["runs"][0]["caches"]
                 if not t.is_floating_point() and t.shape[0] == window]
        assert rings
        for pos in rings:
            half = window // 2
            assert int(pos[:half].max()) >= window and int(pos[half:].max()) >= window


def test_build_with_a_mesh_gives_the_sharded_step(ranks):
    """``launch.train.build(mesh=, param_shardings=)`` is
    ``make_train_step(mesh=)``: one step from the same blocks, bitwise."""
    for res in ranks:
        built, direct = res["build_step"]["build"], res["build_step"]["direct"]
        assert W._same_bits(built["loss"], direct["loss"])
        assert W._same_bits(built["params"], direct["params"])


@pytest.mark.parametrize("what", ["groups", "gate_blocks", "ssm_groups"])
def test_serve_layout_refuses_what_it_does_not_serve(what):
    """Query heads a rank that do not fall on whole groups of one kv head's
    queries; an RG-LRU cache cut by channels that are not whole gate
    blocks, its weights whole; an SSM state cut by heads with more than
    one group of B and C."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.steps import _serving
    from repro_torch.models.model import init_params, param_axes

    mesh, rules = abstract_mesh((1, 2), ("data", "model")), SH.TP_ONLY_RULES
    if what == "groups":  # 6 query heads over 3 kv heads: 3 a rank, groups of 2
        cfg = dataclasses.replace(get_arch("deepseek-7b", tiny=True), n_heads=6, n_kv_heads=3,
                                  d_head=16)
        match = "whole groups"
    elif what == "gate_blocks":  # 64 channels over 32 ranks: 2 a rank, gate blocks of 4
        cfg = get_arch("recurrentgemma-9b", tiny=True)
        mesh, rules = abstract_mesh((1, 32), ("data", "model")), SH.SMALL_MODEL_RULES
        match = "whole gate blocks"
    else:  # 8 heads over 2 ranks, 2 groups of B and C
        base = get_arch("mamba2-780m", tiny=True)
        cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm, n_groups=2))
        rules = SH.SMALL_MODEL_RULES
        match = "one group of B and C"
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, rules, meta)
    plan, _ = _serving(cfg, mesh, specs)(2, 16)
    with pytest.raises(NotImplementedError, match=match):
        plan.serve_layout(0)
