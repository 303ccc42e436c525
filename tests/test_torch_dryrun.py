"""The dry run (``launch.dryrun``) held to a real sharded step.

One spawn of four gloo CPU ranks on (2, 2) runs one sharded step of tiny
deepseek-7b (DEFAULT_RULES: FSDP, TP, vocab TP; guarded, so the census
combine is in it), of tiny granite-moe-1b-a400m (SMALL_MODEL_RULES: FSDP,
vocab TP, EP), under DEFAULT_RULES of tiny minicpm3-4b (MLA's TP, its f
on the latents), tiny recurrentgemma-9b (the RG-LRU's channels, local
attention's gathered kv head), tiny llama-3.2-vision-11b (cross-
attention on a seeded context, its gates open) and tiny mamba2-780m (the
SSM's heads: xbc and conv_w gathered over "model", the gated norm's
statistic summed both ways, dt and its f32 leaves through f), and under
SMALL_MODEL_RULES of tiny musicgen-medium (the codebook table gathered
over "data", the stacked streams' lookup sum, the K streams' loss
statistics; tokens (rows, seq + 1, 4) below its vocabulary of 64), and of
tiny minicpm3-4b at 3 heads under DEFAULT_RULES (MLA's heads not dividing
"model": q_up, kv_up and o gathered over it, 1 and 2 heads a rank); a
second spawn of three ranks on (1, 3) runs tiny minicpm3-4b's 4 heads
(q_up gathered, kv_up and o whole through ``sum_backward``, 1, 1 and 2
heads a rank). Each with two microbatches, noting every collective
(``core.collectives.traffic``) and every c10d op (``reduce.inspect``'s
meter). On the meta device, with nothing allocated, the dry run's

  * per-rank bytes (parameter blocks, AdamW moments, f32 accumulators)
    equal the bytes of the blocks the ranks hold, exactly;
  * modelled collective bytes (``step_collectives``) equal the noted
    traffic by kind and axis, and their total the c10d all-gathers' bytes
    (``collective_recv_bytes``' measure), exactly.

``--all --mesh single`` runs on the CPU without allocating (a dispatch
mode refuses any tensor off the meta device past a few elements), every
cell that runs its shape ``ok``, minicpm3-4b's too (its 40 query heads
over 16 model ranks, 2 or 3 a rank), and deepseek-7b train_4k reports its
per-rank bytes on (2, 2) and (16, 16).
On (2, 2) the train, prefill and decode cells of minicpm3-4b,
recurrentgemma-9b, llama-3.2-vision-11b, mamba2-780m and musicgen-medium
are ``ok``.

The serving cells are held to the one sharded serving spawn of
``tests/torch_serving_cases.py`` (shared with
``tests/test_torch_sharded_serving.py``; every block kind and the
codebook streams): for each case the modelled bytes of a rank
(``serve_rank_bytes``: parameter blocks, cache blocks -- the latent, the
SSM's f32 state and conv block, the RG-LRU's channels, a ring's slots,
the cross-attention cache's kv heads or image tokens -- and the prefill's
gathered logits) equal the allocated blocks, and the modelled collectives
of the prefill and of one decode step, greedy and not
(``serve_collectives``), equal the noted traffic by kind and axis and the
c10d all-gathers' bytes, exactly.
"""

import collections
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as ref_arch
from repro.models import init_params as ref_init
from repro_torch.configs import TrainConfig
from repro_torch.launch import dryrun, sharding as SH
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.model import init_params, param_axes

import torch_mesh_workers as W
import torch_serving_cases as SC

# name -> (arch, rules, guarded, config overrides, mesh)
CASES = {"deepseek": ("deepseek-7b", "DEFAULT_RULES", True, {}, (2, 2)),
         "granite": ("granite-moe-1b-a400m", "SMALL_MODEL_RULES", False, {}, (2, 2)),
         "minicpm3": ("minicpm3-4b", "DEFAULT_RULES", False, {}, (2, 2)),
         "recurrentgemma": ("recurrentgemma-9b", "DEFAULT_RULES", False, {}, (2, 2)),
         "vision": ("llama-3.2-vision-11b", "DEFAULT_RULES", False, {}, (2, 2)),
         "mamba2": ("mamba2-780m", "DEFAULT_RULES", False, {}, (2, 2)),
         "musicgen": ("musicgen-medium", "SMALL_MODEL_RULES", False, {}, (2, 2)),
         "minicpm3_heads3": ("minicpm3-4b", "DEFAULT_RULES", False,
                             {"n_heads": 3, "n_kv_heads": 3}, (2, 2)),
         "minicpm3_1x3": ("minicpm3-4b", "DEFAULT_RULES", False, {}, (1, 3))}
MICRO, ROWS, SEQ = 2, 8, 32


def _case(arch, rules, guard, over, _):
    cfg = dataclasses.replace(ref_arch(arch, tiny=True), dtype="float32", **over)
    params = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(5), cfg)[0])
    rng = np.random.default_rng(3)
    shape = (ROWS, SEQ + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    tokens = [rng.integers(0, min(256, cfg.vocab_size), shape).astype(np.int64)]
    case = dict(arch=arch, dtype="float32", kernels=False, rules=rules, micro=MICRO, cfg=over,
                params=params, tokens=tokens, runs=1, meter=True, guard=guard)
    if guard:
        case["scales"] = [np.ones(4, np.float32)]
    if cfg.n_img_tokens:  # the context, and the gates open (0 at init)
        case["ctx"] = [rng.standard_normal((ROWS, cfg.n_img_tokens, cfg.d_model))
                       .astype(np.float32)]
        case["gate"] = 0.5
    return case


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's ranks: one spawn a mesh."""
    out = {}
    for shape in sorted({spec[-1] for spec in CASES.values()}):
        cases = {name: _case(*spec) for name, spec in CASES.items() if spec[-1] == shape}
        got = W.run_mesh("sharded_cases", shape, ("data", "model"),
                         tmp_path_factory.mktemp("dryrun"), cases)
        out.update({name: [r[name] for r in got] for name in cases})
    return out


def _model(name):
    arch, rules, guard, over, shape = CASES[name]
    cfg = dataclasses.replace(W.sharded_cfg(arch, "float32", False), **over)
    mesh = abstract_mesh(shape, ("data", "model"))
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta)
    tcfg = TrainConfig(microbatches=MICRO)
    return cfg, tcfg, mesh, specs, guard


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_bytes_equal_the_allocated_blocks(ranks, name):
    cfg, tcfg, mesh, specs, _ = _model(name)
    want = dryrun.rank_bytes(cfg, tcfg, mesh, specs)
    for r in ranks[name]:
        for k in ("params", "moments", "accumulators"):
            assert r["block_bytes"][k] == want[k], k
    assert want["peak"] > want["params"] + want["moments"] + want["accumulators"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_modelled_collectives_equal_the_metered_ones(ranks, name):
    cfg, tcfg, mesh, specs, guard = _model(name)
    model = dryrun.step_collectives(cfg, tcfg, mesh, specs, (ROWS, SEQ + 1), guard=guard)
    by_kind_axis = collections.Counter()
    for (kind, ax, _), b in model.items():
        by_kind_axis[(kind, ax)] += b
    total = sum(model.values())
    for r in ranks[name]:
        noted = collections.Counter()
        for kind, ax, b in r["traffic"]:
            noted[(kind, ax)] += b
        assert noted == by_kind_axis
        gathered = sum(out - inb for op, inb, out in r["c10d"]
                       if op in ("allgather_", "_allgather_base_",
                                 "allgather_into_tensor_coalesced_"))
        assert gathered == total
        assert all(op.startswith("allgather") or op == "_allgather_base_"
                   for op, _, _ in r["c10d"])
    summary = dryrun.summarize(model)
    assert summary["total_bytes"] == total == sum(summary["by_kind"].values()) == sum(
        summary["by_depth"].values())


class _NoAllocation(TorchDispatchMode):
    """Fails on any op that makes a tensor of more than 4096 elements off
    the meta device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" and t.numel() > 4096:
                raise AssertionError(f"{func} made a {tuple(t.shape)} tensor on {t.device}")
        return out


def test_all_cells_on_the_production_mesh_allocate_nothing(tmp_path, capsys):
    with _NoAllocation():
        assert dryrun.main(["--all", "--mesh", "single", "--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "[FAIL]" not in text and "nothing was allocated" in text
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 40
    ok = {r["arch"] for r in recs if r["status"] == "ok"}
    served = {"olmo-1b", "internlm2-1.8b", "deepseek-7b", "granite-moe-1b-a400m", "dbrx-132b",
              "minicpm3-4b", "recurrentgemma-9b", "llama-3.2-vision-11b", "mamba2-780m",
              "musicgen-medium"}
    assert ok == served
    for r in recs:
        if r["arch"] in ("mamba2-780m", "musicgen-medium") and r["mode"] == "train":
            assert r["status"] == "ok" and r["rules"] == "SMALL_MODEL_RULES"
    serving = [r for r in recs if r["mode"] != "train" and r["status"] != "skipped"]
    assert all(r["status"] in ("ok", "refused") for r in recs if r["status"] != "skipped")
    assert {r["arch"] for r in serving if r["status"] == "ok"} == served
    # minicpm3-4b's 40 heads over 16 model ranks run, 2 or 3 a rank, with
    # its fit verdicts
    mla = [r for r in recs if r["arch"] == "minicpm3-4b" and r["status"] != "skipped"]
    assert sorted(r["mode"] for r in mla) == ["decode", "prefill", "train"]
    for r in mla:
        assert r["status"] == "ok" and r["fits_80gb_card_per_rank"], r["shape"]
        assert r["collectives"]["total_bytes"] > 0
    cells = {(r["arch"], r["shape"]): r for r in serving}
    for arch in ("deepseek-7b", "internlm2-1.8b", "dbrx-132b"):
        assert cells[(arch, "decode_32k")]["status"] == "ok"
        assert cells[(arch, "decode_32k")]["fits_80gb_card_per_rank"]
    assert '"waits"' not in text and "[waits]" not in text


@pytest.mark.parametrize("mesh_name", ["2x2", "single"])
def test_deepseek_train_4k_per_rank_bytes(tmp_path, mesh_name):
    rec = dryrun.run_cell("deepseek-7b", "train_4k", mesh_name, tmp_path)
    assert rec["status"] == "ok" and rec["rules"] == "DEFAULT_RULES"
    b = rec["bytes_per_rank"]
    ranks = 4 if mesh_name == "2x2" else 256
    # parameters: every rank a 1 / ranks share of the TP+FSDP-cut leaves,
    # the vocab leaves cut over "model" only
    assert b["moments"] == 2 * b["accumulators"]
    assert b["params"] * ranks > 2 * 6.9e9
    assert rec["collectives"]["total_bytes"] > 0
    assert (tmp_path / f"deepseek-7b__train_4k__{mesh_name}.json").exists()


@pytest.fixture(scope="module")
def serving_ranks(request, tmp_path_factory):
    return SC.serving_ranks(request, tmp_path_factory)


def _by_kind_axis(records) -> collections.Counter:
    out = collections.Counter()
    for key, b in records.items():
        out[key[:2]] += b
    return out


@pytest.mark.parametrize("name", SC.CASES)
def test_serving_cells_equal_the_metered_run(serving_ranks, name):
    case = SC.case(name)
    cfg = W.serving_cfg(case)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, case["rules"]), meta)
    batch, prompt = case["prompts"].shape[:2]
    want = dryrun.serve_rank_bytes(cfg, mesh, specs, "prefill", batch, prompt,
                                   s_max=case["s_max"])
    for mode, greedy in (("prefill", False), ("decode", False), ("decode", True)):
        model = dryrun.serve_collectives(cfg, mesh, specs, mode, batch,
                                         prompt if mode == "prefill" else case["s_max"],
                                         greedy=greedy, s_max=case["s_max"])
        if greedy:
            mode = "greedy"
        for r in serving_ranks:
            res = r[name]
            noted = collections.Counter()
            for kind, ax, b in res[f"{mode}_traffic"]:
                noted[(kind, ax)] += b
            assert noted == _by_kind_axis(model), mode
            gathered = sum(out - inb for op, inb, out in res[f"{mode}_c10d"]
                           if op.startswith("allgather") or op == "_allgather_base_")
            assert gathered == sum(model.values()), mode
            assert all(op.startswith("allgather") or op == "_allgather_base_"
                       for op, _, _ in res[f"{mode}_c10d"])
    for r in serving_ranks:
        for k in ("params", "caches", "logits"):
            assert r[name]["block_bytes"][k] == want[k], k
    assert want["need"] > want["params"] + want["caches"] + want["logits"]


def test_the_new_mixers_train_cells_on_2x2(tmp_path):
    """On (2, 2): the train, prefill and decode cells of the MLA, SSM,
    RG-LRU, cross-attention and codebook archs ``ok``, each with
    collectives (the serving cells' by their own block kinds)."""
    from repro_torch.configs import SHAPES, get_arch, get_shape
    from repro_torch.configs.base import shape_applicable

    for arch in ("minicpm3-4b", "recurrentgemma-9b", "llama-3.2-vision-11b", "mamba2-780m",
                 "musicgen-medium"):
        for shape in SHAPES:
            if not shape_applicable(get_arch(arch), get_shape(shape))[0]:
                continue
            rec = dryrun.run_cell(arch, shape, "2x2", tmp_path)
            assert rec["status"] == "ok", (arch, shape, rec.get("reason"))
            assert rec["collectives"]["total_bytes"] > 0
