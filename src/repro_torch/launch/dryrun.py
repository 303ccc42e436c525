"""The dry run of the sharded training step, on the meta device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles every
(arch x shape x mesh) cell against the production meshes and reads the
memory and the collectives out of the compiled HLO. Here nothing is
compiled or allocated: for each training cell the parameters are meta
tensors (``launch.specs``), their specs come from the reference's rules
choice, and this module computes, for a rank of the mesh,

  bytes        its blocks of the parameters, AdamW's two f32 moments, the
               f32 gradient accumulators, the step's peak
               (``launch.train.sharded_step_peak_bytes``, activations
               aside), and what the fit verdict charges beside that peak:
               the activation reserve over the batch ranks, as
               ``launch.train.check_fits_card(shard=)`` charges it, and
               the checkpointed block inputs of a microbatch (its rows x
               seq x d_model x the activations' bytes x layers), which
               grow with the cell's batch;
  collectives  the bytes each collective of the sharded step
               (``launch.steps`` with ``mesh=``) brings into the rank, by
               kind (all-gather, reduce-scatter, all-reduce: a fixed-order
               combine) and by depth: once a "step", per "microbatch", per
               "block" per microbatch, per loss "chunk" per microbatch --
               the counterpart of the reference's ``parse_collective_bytes``
               and ``parse_collective_depths``, computed from the sharded
               step's structure (``step_collectives``), not from HLO. A
               collective over an axis of P ranks brings in P - 1 times its
               operand (gloo has no reduce-scatter: that one gathers whole
               tensors), which is what ``core.collectives.traffic`` notes
               and the launch meter (``reduce.inspect.collective_recv_bytes``)
               counts of a real run (``tests/test_torch_dryrun.py`` holds
               them equal on a tiny (2, 2) run, byte for byte).

Every rank's blocks have the same shapes (the rules cut a dim only where
it divides), so the figures are those of every rank. Prefill and decode
cells wait for sharded serving and say so; archs whose blocks the sharded
step does not run (``models.parallel.Plan``: MLA, SSM, RG-LRU,
cross-attention, codebook streams) get their bytes and the refusal's
reason.

  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh 2x2
  python -m repro_torch.launch.dryrun --all --mesh single

Each cell's JSON goes to ``--out`` (``artifacts/dryrun_torch`` by default,
which ``.gitignore`` lists).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import pathlib

from repro_torch import reduce as R
from repro_torch.configs import ARCHS, SHAPES, TrainConfig, get_arch, get_shape
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SPECS
from repro_torch.launch.mesh import abstract_mesh, abstract_production_mesh
from repro_torch.launch.train import (ACTIVATION_RESERVE_BYTES, sharded_step_peak_bytes,
                                      shard_shapes)
from repro_torch.models.parallel import Plan

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
KINDS = ("all-gather", "reduce-scatter", "all-reduce")
DEPTHS = ("step", "microbatch", "block", "chunk")
LOSS_CHUNK = 512  # models.losses.lm_loss_chunked's seq_chunk
CARD_BYTES = 80 * 10**9


def mesh_named(name: str):
    """"single" (16, 16), "multi" (2, 16, 16), or "AxB" over ("data",
    "model"), as shapes alone."""
    if name in ("single", "multi"):
        return abstract_production_mesh(multi_pod=name == "multi")
    shape = tuple(int(n) for n in name.split("x"))
    return abstract_mesh(shape, ("data", "model")[-len(shape):] if len(shape) <= 2 else
                         ("pod", "data", "model"))


def rules_for(cfg, mode: str) -> str:
    """The name of the reference's rules choice (``build_cell``): FSDP over
    data (and over the pod axis past 40 B parameters), TP dropped under
    3 B; serving TP only."""
    if cfg.param_count() > 40e9:
        return "BIG_MODEL_RULES"
    if cfg.param_count() < 3e9:
        return "SMALL_MODEL_RULES"
    return "DEFAULT_RULES" if mode == "train" else "TP_ONLY_RULES"


def _meta_params(cfg):
    return SPECS.param_specs(cfg)[0]


def step_collectives(cfg, tcfg, mesh, specs, tokens_shape, *, guard: bool = False) -> dict:
    """``{(kind, axis, depth): bytes}`` a rank brings in over one sharded
    training step (``launch.steps.make_train_step`` / ``make_guarded_
    train_step`` with ``mesh=``) on a global batch of ``tokens_shape``
    ((GB, S + 1): the forward sees S positions)."""
    plan = Plan(cfg, mesh, specs)
    params = _meta_params(cfg)
    n_micro = tcfg.microbatches
    rows = tokens_shape[0] // n_micro // plan.data_degree
    seq = tokens_shape[1] - 1
    act = params["embed"]["table"].element_size()  # activations in the parameters' dtype
    hidden = rows * seq * cfg.d_model * act
    out: collections.Counter = collections.Counter()

    def note(kind, axis, depth, nbytes, times=1):
        size = mesh.axis_size(axis)
        if size > 1:
            out[(kind, axis, depth)] += (size - 1) * int(nbytes) * times

    def fsdp(tree, spec_tree, depth, forwards):
        # each batch-cut dim gathered (the last axis first) forwards times,
        # its gradient reduce-scattered once (the first axis first)
        for t, sp in zip(R.tree_leaves(tree), SH.tree_leaves(spec_tree)):
            shape = list(SH.local_shape(t.shape, sp, mesh))
            cut = [(i, [ax for ax in SH.entry_axes(e) if ax in plan.batch])
                   for i, e in enumerate(sp)]
            cut = [(i, axes) for i, axes in cut if axes]
            for i, axes in cut:
                for ax in reversed(axes):
                    note("all-gather", ax, depth, math.prod(shape) * t.element_size(), forwards)
                    shape[i] *= mesh.axis_size(ax)
            for i, axes in reversed(cut):
                for ax in axes:
                    note("reduce-scatter", ax, depth, math.prod(shape) * t.element_size())
                    shape[i] //= mesh.axis_size(ax)

    fw = 2 if cfg.remat else 1  # a block's forward and its recompute
    model = plan.model
    if plan.vocab_parallel:
        note("all-reduce", model, "microbatch", hidden)  # the lookup's sum
    for p, sp in zip(params["layers"], specs["layers"]):
        lay = plan.layout(sp)
        fsdp(p, sp, "block", fw)
        if lay["kv"] in ("gather", "whole"):
            cols = cfg.n_kv_heads * cfg.d_head
            for name in ("k", "v"):
                es = p["mix"][name]["w"].element_size()
                whole = cfg.d_model * cols * es
                if lay["kv"] == "gather":
                    note("all-gather", model, "block", whole // mesh.axis_size(model), fw)
                    note("reduce-scatter", model, "block", whole)
                else:
                    note("all-reduce", model, "block", whole)
        for tp in ("attn_tp", "ffn_tp"):
            if lay[tp]:
                note("all-reduce", model, "block", hidden, fw)  # o / down: g
                note("all-reduce", model, "block", hidden)      # the input's f
        if lay["ep"] is not None:
            stats = 2 * cfg.moe.n_experts * 4
            for ax in plan.batch:  # the load-balance sums, both ways
                note("all-reduce", ax, "block", stats, fw + 1)
            if lay["ep"] == "model":
                note("all-reduce", model, "block", hidden, fw)   # the combine
                note("all-reduce", model, "block", hidden)       # the dispatch's f
                note("all-reduce", model, "block", rows * seq * cfg.moe.top_k * 4)  # gates' f
    fsdp(params["final_norm"], specs["final_norm"], "microbatch", 1)
    if plan.vocab_parallel:
        chunk = min(LOSS_CHUNK, seq)
        chunks = -(-seq // chunk)
        # the kernel's statistics (forward, recompute), the exact ones (backward)
        note("all-gather", model, "chunk", rows * chunk * 3 * 4, 3 * chunks)
        note("all-reduce", model, "chunk", rows * chunk * cfg.d_model * act, chunks)  # head's f
    for key in list(out):
        out[key] *= n_micro
    # once a step: the gradients of leaves whole along a batch axis, the
    # loss, the clip statistic (and the census)
    for t, sp in zip(R.tree_leaves(params), SH.tree_leaves(specs)):
        for ax in plan.batch:
            if ax not in SH.spec_axes(sp):
                note("all-reduce", ax, "step", math.prod(SH.local_shape(t.shape, sp, mesh)) * 4)
    for ax in plan.batch:
        note("all-reduce", ax, "step", 4)
    n_leaves = len(R.tree_leaves(params))
    for ax in mesh.axis_names:
        note("all-reduce", ax, "step", 4 * n_leaves)
        if guard:
            note("all-reduce", ax, "step", 4)
    return dict(out)


def summarize(records: dict) -> dict:
    """Totals of ``step_collectives`` by kind, by depth and in all."""
    by_kind = {k: sum(b for (kk, _, _), b in records.items() if kk == k) for k in KINDS}
    by_depth = {d: sum(b for (_, _, dd), b in records.items() if dd == d) for d in DEPTHS}
    by_axis = collections.Counter()
    for (_, ax, _), b in records.items():
        by_axis[ax] += b
    return {"by_kind": by_kind, "by_depth": by_depth, "by_axis": dict(by_axis),
            "total_bytes": sum(records.values())}


def rank_bytes(cfg, tcfg, mesh, specs, *, guard: bool = False) -> dict:
    """A rank's bytes: its parameter blocks, AdamW's moments, the f32
    accumulators and the step's peak (activations aside)."""
    shapes = shard_shapes(cfg, mesh, specs)
    n = sum(k for k, _ in shapes)
    return {"params": sum(k * size for k, size in shapes),
            "moments": 4 * n * (1 if tcfg.fused_second_moment else 2),
            "accumulators": 4 * n,
            "peak": sharded_step_peak_bytes(cfg, tcfg, mesh, specs, guard=guard)}


def activation_bytes(cfg, tcfg, mesh, tokens_shape) -> dict:
    """What a rank's fit is charged beside the step's peak on a global
    batch of ``tokens_shape`` ((GB, S + 1)): the reserve over the batch
    ranks (``check_fits_card(shard=)``'s charge, which covers one block's
    working set as measured at 4 x 512) and the checkpointed input of
    every block for one microbatch of the rank's rows."""
    data = mesh.size // mesh.axis_size("model")
    rows = tokens_shape[0] // tcfg.microbatches // data
    act = _meta_params(cfg)["embed"]["table"].element_size()
    return {"reserve": ACTIVATION_RESERVE_BYTES // data,
            "block_inputs": rows * (tokens_shape[1] - 1) * cfg.d_model * act * cfg.n_layers}


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir=None, *,
             n_layers=None) -> dict:
    """One cell's record (written as JSON under ``out_dir`` when given)."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "mode": shape.mode,
           "n_layers": cfg.n_layers}
    runs, reason = shape_applicable(cfg, shape)
    if not runs:
        rec.update(status="skipped", reason=reason)
    elif shape.mode != "train":
        rec.update(status="waits", reason="prefill and decode cells wait for sharded serving")
    else:
        mesh = mesh_named(mesh_name)
        rules = rules_for(cfg, shape.mode)
        meta, axes = SPECS.param_specs(cfg)
        specs = SH.param_shardings(axes, mesh, getattr(SH, rules), meta)
        data = mesh.size // mesh.axis_size("model")
        tcfg = TrainConfig(microbatches=SPECS.microbatches_for(cfg, shape, data))
        rec.update(status="ok", rules=rules, mesh_shape=list(mesh.shape),
                   axes=list(mesh.axis_names),
                   microbatches=tcfg.microbatches, bytes_per_rank=rank_bytes(cfg, tcfg, mesh,
                                                                            specs))
        b = rec["bytes_per_rank"]
        b.update(activation_bytes(cfg, tcfg, mesh, (shape.global_batch, shape.seq_len)))
        b["need"] = b["peak"] + b["reserve"] + b["block_inputs"]
        rec["fits_80gb_card_per_rank"] = b["need"] <= CARD_BYTES
        try:
            records = step_collectives(cfg, tcfg, mesh, specs,
                                       (shape.global_batch, shape.seq_len))
            rec["collectives"] = summarize(records)
            rec["collectives"]["records"] = [[k, ax, d, b] for (k, ax, d), b in
                                             sorted(records.items())]
        except NotImplementedError as e:
            rec.update(status="refused", reason=str(e))
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(json.dumps(rec,
                                                                                   indent=1))
    return rec


def describe(rec: dict) -> str:
    head = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if rec["status"] in ("skipped", "waits"):
        return f"[{rec['status']}] {head}: {rec['reason']}"
    b = rec["bytes_per_rank"]
    line = (f"[{rec['status']}] {head} ({rec['rules']}, {rec['microbatches']} "
            f"microbatches): a rank holds params {b['params'] / 1e9:.2f} GB, moments "
            f"{b['moments'] / 1e9:.2f} GB, accumulators {b['accumulators'] / 1e9:.2f} GB; step "
            f"peak {b['peak'] / 1e9:.2f} GB before activations, {b['need'] / 1e9:.2f} GB with "
            f"the reserve {b['reserve'] / 1e9:.2f} and the checkpointed block inputs "
            f"{b['block_inputs'] / 1e9:.2f} ("
            f"{'fits' if rec['fits_80gb_card_per_rank'] else 'does not fit'} an 80 GB card; "
            "a model figure)")
    if rec["status"] == "refused":
        return line + f"; the sharded step refuses it: {rec['reason']}"
    c = rec["collectives"]
    return line + (f"; collectives {c['total_bytes'] / 1e9:.3f} GB a step a rank "
                   f"({', '.join(f'{k} {v / 1e9:.3f}' for k, v in c['by_kind'].items())}; "
                   f"by depth {', '.join(f'{k} {v / 1e9:.3f}' for k, v in c['by_depth'].items())})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", help="single, multi, both, or AxB (data x model)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layers", type=int, default=None, help="cut the arch to this depth")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                print(describe(run_cell(arch, shape, mesh, args.out, n_layers=args.layers)),
                      flush=True)
    print("dry run complete: nothing was allocated (meta device)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
