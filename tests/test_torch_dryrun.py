"""The dry run (``launch.dryrun``) held to a real sharded step.

One spawn of four gloo CPU ranks on (2, 2) runs one sharded step of tiny
deepseek-7b (DEFAULT_RULES: FSDP, TP, vocab TP; guarded, so the census
combine is in it) and of tiny granite-moe-1b-a400m (SMALL_MODEL_RULES: FSDP,
vocab TP, EP), with two microbatches, and notes every collective
(``core.collectives.traffic``) and every c10d op (``reduce.inspect``'s
meter). On the meta device, with nothing allocated, the dry run's

  * per-rank bytes (parameter blocks, AdamW moments, f32 accumulators)
    equal the bytes of the blocks the ranks hold, exactly;
  * modelled collective bytes (``step_collectives``) equal the noted
    traffic by kind and axis, and their total the c10d all-gathers' bytes
    (``collective_recv_bytes``' measure), exactly.

``--all --mesh single`` runs on the CPU without allocating (a dispatch
mode refuses any tensor off the meta device past a few elements), and
deepseek-7b train_4k reports its per-rank bytes on (2, 2) and (16, 16).
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

CASES = {"deepseek": ("deepseek-7b", "DEFAULT_RULES", True),
         "granite": ("granite-moe-1b-a400m", "SMALL_MODEL_RULES", False)}
MICRO, ROWS, SEQ = 2, 8, 32


def _case(arch, rules, guard):
    cfg = dataclasses.replace(ref_arch(arch, tiny=True), dtype="float32")
    params = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(5), cfg)[0])
    rng = np.random.default_rng(3)
    tokens = [rng.integers(0, 256, (ROWS, SEQ + 1)).astype(np.int64)]
    case = dict(arch=arch, dtype="float32", kernels=False, rules=rules, micro=MICRO,
                params=params, tokens=tokens, runs=1, meter=True, guard=guard)
    if guard:
        case["scales"] = [np.ones(4, np.float32)]
    return case


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: _case(*spec) for name, spec in CASES.items()}
    out = W.run_mesh("sharded_cases", (2, 2), ("data", "model"),
                     tmp_path_factory.mktemp("dryrun"), cases)
    return {name: [r[name] for r in out] for name in cases}


def _model(name):
    arch, rules, guard = CASES[name]
    cfg = W.sharded_cfg(arch, "float32", False)
    mesh = abstract_mesh((2, 2), ("data", "model"))
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
    assert ok == {"olmo-1b", "internlm2-1.8b", "deepseek-7b", "granite-moe-1b-a400m",
                  "dbrx-132b"}
    assert all(r["status"] == "waits" for r in recs if r["mode"] != "train"
               and r["status"] != "skipped")


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
