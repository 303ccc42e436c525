"""The dry run of the sharded steps, on the meta device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles every
(arch x shape x mesh) cell against the production meshes and reads the
memory and the collectives out of the compiled HLO. Here nothing is
compiled or allocated: for each cell the parameters are meta tensors
(``launch.specs``), their specs come from the reference's rules choice
(``rules_for``), and this module computes, for a rank of the mesh,

  bytes        training: its blocks of the parameters, AdamW's two f32
               moments, the f32 gradient accumulators, the step's peak
               (``launch.train.sharded_step_peak_bytes``, activations
               aside), and what the fit verdict charges beside that peak:
               the activation reserve over the batch ranks, as
               ``launch.train.check_fits_card(shard=)`` charges it, and
               the checkpointed block inputs of a microbatch (its rows x
               seq x d_model x the activations' bytes x layers), which
               grow with the cell's batch. Prefill and decode
               (``serve_rank_bytes``): its parameter blocks, its cache
               blocks (``launch.sharding.cache_shardings``), the logits it
               returns, and the working set of one block (the largest
               gathered block, the head's f32 copy, one block's
               activations);
  collectives  the bytes each collective of the sharded step
               (``launch.steps`` with ``mesh=``) brings into the rank, by
               kind (all-gather, reduce-scatter, all-reduce: a fixed-order
               combine) and by depth: once a "step", per "microbatch", per
               "block" per microbatch, per loss "chunk" per microbatch --
               the counterpart of the reference's ``parse_collective_bytes``
               and ``parse_collective_depths``, computed from the step's
               structure (``step_collectives``; ``serve_collectives`` for
               a prefill or one decode step: "step" and "block"), not from
               HLO. A collective over an axis of P ranks brings in P - 1
               times its operand (gloo has no reduce-scatter: that one
               gathers whole tensors), which is what
               ``core.collectives.traffic`` notes and the launch meter
               (``reduce.inspect.collective_recv_bytes``) counts of a real
               run (``tests/test_torch_dryrun.py`` holds them equal on tiny
               (2, 2) runs, byte for byte).

Every rank's blocks have the same shapes (the rules cut a dim only where
it divides), so the figures are those of every rank. The training cells
run every block kind and codebook streams (``models.parallel.Plan``:
attention, global or local, MLA, the SSM, the RG-LRU and cross-attention,
each mixer's collectives counted as it runs them), and so do the serving
cells (``models.parallel.Plan.serve_layout``: each kind's cache cut as
``cache_shardings`` cuts it, its collectives and its working set by
kind); cuts a block cannot run (MLA's 40 heads over 16 model ranks) get
``refused`` with the layout's reason (a training cell its bytes too).

  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh 2x2
  python -m repro_torch.launch.dryrun --all --mesh single

Each cell's JSON goes to ``--out`` (``artifacts/dryrun_torch`` by default,
which ``.gitignore`` lists); ``--skip-existing`` keeps a cell whose JSON
is there already with a verdict at the depth asked for (``existing_cell``).
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
from repro_torch.launch.specs import META
from repro_torch.launch.train import (ACTIVATION_RESERVE_BYTES, sharded_step_peak_bytes,
                                      shard_shapes)
from repro_torch.models import make_caches
from repro_torch.models import moe as MOE
from repro_torch.models import params as P
from repro_torch.models import rglru as REC
from repro_torch.models import ssm as SSM
from repro_torch.models.parallel import Plan

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
KINDS = ("all-gather", "reduce-scatter", "all-reduce")
DEPTHS = ("step", "microbatch", "block", "chunk")
LOSS_CHUNK = 512  # models.losses.lm_loss_chunked's seq_chunk
CARD_BYTES = 80 * 10**9
# cuBLAS's and cuBLASLt's workspaces, which PyTorch takes from its caching
# allocator on the rank's first GEMMs (so a rank's peak counts them): a
# serving rank's bytes are charged 64 MiB for them.
LIBRARY_WORKSPACE_BYTES = 64 << 20


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
    books = max(1, cfg.n_codebooks)  # the streams: looked up and scored each
    fsdp(params["embed"], specs["embed"], "microbatch", 1)  # a codebook table's d
    if plan.vocab_parallel:
        note("all-reduce", model, "microbatch", books * hidden)  # the lookup's sum
    if cfg.mla is not None:  # MLA's f: the two normed latents and the shared key
        m = cfg.mla
        mla_f = rows * seq * (m.q_lora_rank + m.kv_lora_rank + m.qk_rope_dim) * act
    for kind, p, sp in zip(cfg.pattern_layers, params["layers"], specs["layers"]):
        lay = plan.layout(sp, kind)
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
        if lay["attn_tp"] or lay["inner_tp"]:
            note("all-reduce", model, "block", hidden, fw)  # o / out: g
            mla = kind == "attn" and cfg.mla is not None
            note("all-reduce", model, "block", mla_f if mla else hidden)  # f
        if kind == "ssm" and lay["inner_tp"]:
            mix, n_model = p["mix"], mesh.axis_size(model)
            note("all-reduce", model, "block", rows * seq * 4, fw + 1)  # the gated norm's ss
            for name in ("xbc", "conv_w"):  # gathered over "model", reduce-scattered
                w = mix[name]["w"] if name == "xbc" else mix[name]
                whole = w.shape[0] * w.shape[1] * w.element_size()
                note("all-gather", model, "block", whole // n_model, fw)
                note("reduce-scatter", model, "block", whole)
            for w in (mix["dt"]["w"], mix["dt_bias"], mix["A_log"], mix["D"]):  # f's sums
                note("all-reduce", model, "block", w.numel() * w.element_size())
        if lay["ffn_tp"]:
            note("all-reduce", model, "block", hidden, fw)  # down: g
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
        note("all-gather", model, "chunk", rows * chunk * books * 3 * 4, 3 * chunks)
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
    working set as measured at 4 x 512), the checkpointed input of every
    block for one microbatch of the rank's rows, and a cross-attention
    arch's context: the rank's rows of every microbatch, (rows, N, d),
    held for the step."""
    data = mesh.size // mesh.axis_size("model")
    rows = tokens_shape[0] // tcfg.microbatches // data
    act = _meta_params(cfg)["embed"]["table"].element_size()
    return {"reserve": ACTIVATION_RESERVE_BYTES // data,
            "block_inputs": rows * (tokens_shape[1] - 1) * cfg.d_model * act * cfg.n_layers,
            "context": tokens_shape[0] // data * cfg.n_img_tokens * cfg.d_model * act}


def _serve_rows(plan, batch: int) -> int:
    """A rank's rows of a serving batch (``Plan.rows``)."""
    deg = plan.data_degree
    return batch // deg if deg > 1 and batch % deg == 0 else batch


def serve_plan(cfg, mesh, specs, batch: int, s_max: int):
    """The serving plan of a cell: the parameters' specs and the caches'
    (``cache_shardings`` of ``batch`` x ``s_max`` slots), as
    ``launch.steps.make_prefill_step`` / ``make_decode_step`` build it."""
    meta = make_caches(cfg, batch, s_max, META)
    return Plan(cfg, mesh, specs).for_caches(meta), meta


def serve_collectives(cfg, mesh, specs, mode: str, batch: int, seq: int, *,
                      greedy: bool = True, s_max=None) -> dict:
    """``{(kind, axis, depth): bytes}`` a rank brings in over one sharded
    prefill of ``batch`` x ``seq`` tokens into caches of ``s_max`` slots
    (``seq`` when None, as the dry run's cells have it), or one decode step
    against caches of ``s_max`` slots (``launch.steps``' serving steps with
    ``mesh=``; ``greedy``: the decode's (max, index) merge, else its logits
    gathered); depth "step" (once) or "block" (once a block). No backward,
    so no reduce-scatter. Each block kind's own (``_block_serve_collectives``):
    attention's and cross-attention's k/v gathers, split-KV partials and
    head gathers; MLA's q gather and latent partials; the SSM's conv-output
    gather and norm statistic, or its heads' y; the RG-LRU's products; and
    Megatron's g of every cut mixer and FFN."""
    s_max = seq if s_max is None else s_max
    plan, _ = serve_plan(cfg, mesh, specs, batch, s_max)
    params = _meta_params(cfg)
    rows = _serve_rows(plan, batch)
    toks = rows * (seq if mode == "prefill" else 1)
    act = params["embed"]["table"].element_size()
    hidden = toks * cfg.d_model * act
    model = plan.model
    books = max(1, cfg.n_codebooks)  # the streams: looked up and scored each
    out: collections.Counter = collections.Counter()

    def note(kind, axis, depth, nbytes):
        if axis is not None and mesh.axis_size(axis) > 1:
            out[(kind, axis, depth)] += (mesh.axis_size(axis) - 1) * int(nbytes)

    def fsdp(tree, spec_tree, depth):
        for t, sp in zip(R.tree_leaves(tree), SH.tree_leaves(spec_tree)):
            shape = list(SH.local_shape(t.shape, sp, mesh))
            for i, e in enumerate(sp):
                for ax in reversed([ax for ax in SH.entry_axes(e) if ax in plan.batch]):
                    note("all-gather", ax, depth, math.prod(shape) * t.element_size())
                    shape[i] *= mesh.axis_size(ax)

    fsdp(params["embed"], specs["embed"], "step")  # a codebook table's d
    if plan.vocab_parallel:
        note("all-reduce", model, "step", books * hidden)  # the lookup's sum
    for i, (kind, p, sp) in enumerate(zip(cfg.pattern_layers, params["layers"],
                                         specs["layers"])):
        lay = plan.serve_layout(i)
        fsdp(p, sp, "block")
        for kind_, nbytes in _block_serve_collectives(cfg, plan, kind, lay, p, sp, mode, rows,
                                                      toks, act):
            note(kind_, model, "block", nbytes)
        for tp in ("attn_tp", "inner_tp", "ffn_tp"):
            if lay[tp]:
                note("all-reduce", model, "block", hidden)  # o / out / down: g
        if lay["ep"] == "model":
            note("all-reduce", model, "block", hidden)  # the combine
    fsdp(params["final_norm"], specs["final_norm"], "step")
    if plan.vocab_parallel:
        cols = P.padded_vocab(cfg.vocab_size) // mesh.axis_size(model)
        note("all-gather", model, "step",
             books * (rows * 2 * 8 if mode == "decode" and greedy else rows * cols * 4))
    return dict(out)


def _block_serve_collectives(cfg, plan, kind, lay, p, sp, mode, rows, toks, act) -> list:
    """A block's own collectives over "model" in one serving step, as
    (kind, bytes of the rank's operand) pairs (``serve_collectives``)."""
    mesh, decode = plan.mesh, mode == "decode"
    out = []
    if kind == "ssm":
        s, _, _, conv_dim = SSM._dims(cfg)
        (h0, h1), (c0, c1) = lay["q_heads"], lay["channels"]
        if (c0, c1) != (0, conv_dim):
            out.append(("all-gather", toks * (c1 - c0) * act))  # the conv's outputs
        if lay["inner_tp"]:
            out.append(("all-reduce", toks * 4))  # the gated norm's statistic
        if lay["gather_heads"]:
            out.append(("all-gather", toks * (h1 - h0) * s.headdim * 4))  # the heads' y
        return out
    if kind == "rec":
        c0, c1 = lay["channels"]
        if lay["gather_heads"]:
            out.append(("all-gather", toks * (c1 - c0) * act))  # the products h * gate
        return out
    q0, q1 = lay["q_heads"]
    if kind != "xattn" and cfg.mla is not None:
        m = cfg.mla
        if decode and lay["cache"] == "seq":
            if (q0, q1) != (0, cfg.n_heads):  # q_c (f32) and q_rope
                out.append(("all-gather", rows * (q1 - q0) * m.kv_lora_rank * 4))
                out.append(("all-gather", rows * (q1 - q0) * m.qk_rope_dim * act))
            out.append(("all-gather", rows * cfg.n_heads * (m.kv_lora_rank + 2) * 4))  # partials
        return out
    d = cfg.d_head
    for name in ("k", "v"):
        w = p["mix"][name]["w"]
        if (plan._model_cut(sp["mix"][name]["w"], 1)
                and not (lay["kv"] == "local" and lay["cache"] == "heads")):
            out.append(("all-gather", math.prod(SH.local_shape(w.shape, sp["mix"][name]["w"],
                                                                mesh)) * w.element_size()))
    if decode and lay["cache"] == "seq":
        if (q0, q1) != (0, cfg.n_heads):
            out.append(("all-gather", rows * (q1 - q0) * d * act))  # q
        out.append(("all-gather", rows * cfg.n_heads * (d + 2) * 4))  # the partials
    if lay["gather_heads"]:
        out.append(("all-gather", toks * (q1 - q0) * d * act))
    return out


def _score_tiles(rows: int, heads: int, sq: int, skv: int, dv: int) -> int:
    """``attention.flash_attention_xla``'s f32 working set: a few
    temporaries of one (q chunk, kv chunk) score tile a head, and the
    chunks' outputs, kept and then concatenated."""
    return 4 * rows * heads * (4 * min(512, sq) * min(1024, skv) + 2 * sq * dv)


def _block_work(cfg, kind, lay, mode, rows, seq, s_max, act, n_model) -> int:
    """One block's activations in a serving step of the rank's ``rows``
    (``serve_rank_bytes``' model figure), its FFN aside: the residual
    stream and its norm (4 d a token), and the mixer's own, by kind."""
    toks = rows * (seq if mode == "prefill" else 1)
    base = toks * 4 * cfg.d_model * act
    if kind == "ssm":
        s, _, _, conv_dim = SSM._dims(cfg)
        (h0, h1), (c0, c1) = lay["q_heads"], lay["channels"]
        hp = (h1 - h0) * s.headdim
        per_tok = (hp + 3 * (c1 - c0) + 2 * conv_dim) * act + (8 * hp + 2 * conv_dim) * 4
        if mode == "prefill":
            q = min(s.chunk, seq)
            pad = -(-seq // q) * q
            # the SSD's chunk tensors: the decay and CB masks, the states
            ssd = 4 * rows * (h1 - h0) * (6 * pad * q + 3 * (pad // q) * s.headdim * s.d_state)
        else:  # the state decayed and the new state beside the cached one
            ssd = 2 * 4 * rows * (h1 - h0) * s.headdim * s.d_state
        return base + toks * per_tok + ssd
    if kind == "rec":
        c0, c1 = lay["channels"]
        w = REC._width(cfg)
        return base + toks * ((c1 - c0) * (3 * act + 12 * 4) + w * act)
    q0, q1 = lay["q_heads"]
    hq = q1 - q0
    if kind != "xattn" and cfg.mla is not None:
        m = cfg.mla
        qk, lat = m.qk_nope_dim + m.qk_rope_dim, m.kv_lora_rank + m.qk_rope_dim
        if mode == "prefill":
            per_tok = 2 * m.q_lora_rank + 3 * lat + hq * (3 * qk + 2 * (m.qk_nope_dim
                                                                          + m.v_head_dim)
                                                           + 2 * m.v_head_dim)
            return base + toks * per_tok * act + _score_tiles(rows, hq, seq, seq, m.v_head_dim)
        s0, s1 = lay["slots"]
        slots = s1 - s0
        # the normed latents (and their f32 copy), the scores, the partials
        return base + rows * (slots * m.kv_lora_rank * (act + 4) + 3 * cfg.n_heads * slots * 4
                              + (n_model + 2) * cfg.n_heads * (m.kv_lora_rank + 2) * 4)
    c0, c1 = lay["cache_heads"]
    heads = 2 * hq + cfg.n_heads * lay["gather_heads"] + 2 * (c1 - c0)
    work = base + toks * heads * cfg.d_head * act
    if kind == "xattn":  # the context, its keys and values, and the chunked attention
        n = cfg.n_img_tokens
        work += rows * n * (cfg.d_model + 2 * (c1 - c0) * cfg.d_head) * act
        if mode == "prefill":
            work += _score_tiles(rows, hq, seq, n, cfg.d_head)
    return work


def serve_rank_bytes(cfg, mesh, specs, mode: str, batch: int, seq: int, *,
                     s_max=None) -> dict:
    """A rank's bytes in a serving cell: its parameter blocks, its cache
    blocks (the KV caches, MLA's latent, the SSM's conv window and f32
    state, the RG-LRU's conv window and f32 ``h``, as ``cache_shardings``
    cuts them), the logits it returns (the prefill's gathered over the
    whole padded vocabulary, each codebook stream's; the greedy decode's
    columns of the rank, never gathered), and the working set beside them
    (a model figure): the largest block's weights gathered (FSDP over the
    batch axes, k and v over "model"), the head's f32 copy of the rank's
    columns, one block's activations of the rank's rows (``_block_work``:
    the residual stream and its norm, each mixer's own -- attention's
    heads, MLA's expanded heads and score tiles or its latent partials,
    the SSM's conv blocks and SSD chunk tensors or its stepped state, the
    RG-LRU's channels, cross-attention's context -- and the FFN's hidden:
    3 f, gate, up and their product; the MoE's at its capacity over the
    rank's experts, with the dispatched rows twice); and the GEMM
    libraries' workspaces (``LIBRARY_WORKSPACE_BYTES``). ``seq``: the
    prompt's length (prefill), ``s_max`` the caches' (``seq`` when
    None)."""
    s_max = seq if s_max is None else s_max
    plan, meta = serve_plan(cfg, mesh, specs, batch, s_max)
    params = _meta_params(cfg)
    rows = _serve_rows(plan, batch)
    toks = rows * (seq if mode == "prefill" else 1)
    act = params["embed"]["table"].element_size()
    n_model = mesh.axis_size(plan.model) if plan.model else 1
    vocab = P.padded_vocab(cfg.vocab_size)
    cols = vocab // n_model if plan.vocab_parallel else vocab
    books = max(1, cfg.n_codebooks)
    caches = sum(math.prod(SH.local_shape(t.shape, s, mesh)) * t.element_size()
                 for t, s in zip(R.tree_leaves(meta), SH.tree_leaves(plan.cache_specs)))
    gathered, work = 0, 0
    for i, (kind, p, sp) in enumerate(zip(cfg.pattern_layers, params["layers"],
                                         specs["layers"])):
        lay = plan.serve_layout(i)
        g = 0
        for t, s in zip(R.tree_leaves(p), SH.tree_leaves(sp)):
            batch_cut = [ax for ax in SH.spec_axes(s) if ax in plan.batch]
            if batch_cut:
                g += math.prod(SH.local_shape(t.shape, s, mesh)) * t.element_size() * (
                    math.prod(mesh.axis_size(ax) for ax in batch_cut) - 1)
        for name in ("k", "v") if "k" in p["mix"] else ():
            w = p["mix"][name]["w"]
            if plan._model_cut(sp["mix"][name]["w"], 1) and lay["kv"] != "local":
                g += w.numel() * w.element_size() // n_model * (n_model - 1)
        gathered = max(gathered, g)
        if "ffn" not in p:
            ffn = 0
        elif cfg.moe is not None:
            e = cfg.moe
            n_exp = e.n_experts // n_model if lay["ep"] == "model" else e.n_experts
            per_row = seq if mode == "prefill" else 1
            ffn = rows * n_exp * MOE.capacity(per_row, cfg) * (2 * cfg.d_model
                                                               + 3 * e.d_ff_expert) * act
        else:
            ffn = toks * 3 * cfg.d_ff // (n_model if lay["ffn_tp"] else 1) * act
        work = max(work, _block_work(cfg, kind, lay, mode, rows, seq, s_max, act, n_model) + ffn)
    out = {"params": sum(k * size for k, size in shard_shapes(cfg, mesh, specs)),
           "caches": caches,
           "logits": books * rows * (vocab if mode == "prefill" else cols) * 4,
           "gathered_block": gathered, "head_f32": cfg.d_model * cols * 4 * books,
           "activations": work, "workspace": LIBRARY_WORKSPACE_BYTES}
    out["need"] = sum(out.values())
    return out


def serve_cell(cfg, shape, mesh, rules: str) -> dict:
    """A prefill or decode cell's record: the rules, a rank's bytes, the
    fit verdict and the collectives (``serve_collectives``); the blocks
    ``Plan`` refuses give ``refused`` with its reason."""
    meta, axes = SPECS.param_specs(cfg)
    specs = SH.param_shardings(axes, mesh, getattr(SH, rules), meta)
    rec = {"rules": rules, "mesh_shape": list(mesh.shape), "axes": list(mesh.axis_names)}
    try:
        b = serve_rank_bytes(cfg, mesh, specs, shape.mode, shape.global_batch, shape.seq_len)
        records = serve_collectives(cfg, mesh, specs, shape.mode, shape.global_batch,
                                    shape.seq_len)
    except NotImplementedError as e:
        return dict(rec, status="refused", reason=str(e))
    rec.update(status="ok", bytes_per_rank=b, fits_80gb_card_per_rank=b["need"] <= CARD_BYTES,
               collectives=summarize(records))
    rec["collectives"]["records"] = [[k, ax, d, n] for (k, ax, d), n in sorted(records.items())]
    return rec


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
        rec.update(serve_cell(cfg, shape, mesh_named(mesh_name), rules_for(cfg, shape.mode)))
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
        b["need"] = b["peak"] + b["reserve"] + b["block_inputs"] + b["context"]
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


# Verdicts ``--skip-existing`` keeps: every status ``run_cell`` writes (the
# reference keeps "ok" and "skipped" and reruns its "failed" cells; a cell
# of the port either has a verdict or raises before writing).
KEPT = ("ok", "skipped", "refused")


def existing_cell(out_dir, arch: str, shape_name: str, mesh_name: str, n_layers=None):
    """The record ``run_cell`` wrote for the cell under ``out_dir``, if it
    holds a kept verdict (``KEPT``) at the depth asked for (the arch's own
    when ``n_layers`` is None); else None."""
    path = pathlib.Path(out_dir) / f"{arch}__{shape_name}__{mesh_name}.json"
    if not path.exists():
        return None
    rec = json.loads(path.read_text())
    depth = get_arch(arch).n_layers if n_layers is None else n_layers
    return rec if rec.get("status") in KEPT and rec.get("n_layers") == depth else None


def _describe_serving(head: str, rec: dict) -> str:
    if rec["status"] == "refused":
        return f"[refused] {head} ({rec['rules']}): the sharded serving step refuses it: " \
               f"{rec['reason']}"
    b, c = rec["bytes_per_rank"], rec["collectives"]
    return (f"[ok] {head} ({rec['rules']}): a rank holds params {b['params'] / 1e9:.2f} GB, "
            f"caches {b['caches'] / 1e9:.2f} GB, logits {b['logits'] / 1e9:.4f} GB; "
            f"{b['need'] / 1e9:.2f} GB with a gathered block {b['gathered_block'] / 1e9:.2f}, "
            f"the head's f32 copy {b['head_f32'] / 1e9:.2f}, a block's activations "
            f"{b['activations'] / 1e9:.2f} and the GEMM workspaces ("
            f"{'fits' if rec['fits_80gb_card_per_rank'] else 'does not fit'} an 80 GB card; "
            f"a model figure); collectives {c['total_bytes'] / 1e9:.4f} GB a step a rank "
            f"({', '.join(f'{k} {v / 1e9:.4f}' for k, v in c['by_kind'].items() if v)}; "
            f"by depth {', '.join(f'{k} {v / 1e9:.4f}' for k, v in c['by_depth'].items() if v)})")


def describe(rec: dict) -> str:
    head = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if rec["status"] == "skipped":
        return f"[{rec['status']}] {head}: {rec['reason']}"
    if rec["mode"] != "train":
        return _describe_serving(head, rec)
    b = rec["bytes_per_rank"]
    line = (f"[{rec['status']}] {head} ({rec['rules']}, {rec['microbatches']} "
            f"microbatches): a rank holds params {b['params'] / 1e9:.2f} GB, moments "
            f"{b['moments'] / 1e9:.2f} GB, accumulators {b['accumulators'] / 1e9:.2f} GB; step "
            f"peak {b['peak'] / 1e9:.2f} GB before activations, {b['need'] / 1e9:.2f} GB with "
            f"the reserve {b['reserve'] / 1e9:.2f}, the checkpointed block inputs "
            f"{b['block_inputs'] / 1e9:.2f} and the context {b['context'] / 1e9:.2f} ("
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
    ap.add_argument("--skip-existing", action="store_true",
                    help="keep a cell whose JSON under --out already holds a verdict")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                prior = existing_cell(args.out, arch, shape, mesh, args.layers) \
                    if args.skip_existing else None
                if prior is not None:
                    print(f"[keep] {arch} x {shape} x {mesh}", flush=True)
                    continue
                print(describe(run_cell(arch, shape, mesh, args.out, n_layers=args.layers)),
                      flush=True)
    print("dry run complete: nothing was allocated (meta device)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
