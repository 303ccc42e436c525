"""The sharded model: FSDP, tensor and expert parallelism over a mesh.

Explicit SPMD in PyTorch's own idiom: one process a rank, a process group
per mesh axis (``launch.mesh``), plain tensors holding each rank's block of
every parameter under its spec (``launch.sharding``), and autograd pairs
for each collective and its transpose (``core.collectives``). Under the
reference's rules (``launch/sharding.py`` of the JAX package):

  FSDP   a dim cut over the batch axes ("embed" -> "data") is gathered
         before its block runs (``gather_scatter``: the all-gather, whose
         backward is the fixed-order reduce-scatter of the gradient); the
         block runs under ``torch.utils.checkpoint``, so its recompute
         gathers again and no gathered weight outlives its block.
  TP     "heads", "kv_heads" and "ffn" over "model": q/k/v and gate/up
         column-parallel (their input through ``sum_backward``, Megatron's
         f), o and down row-parallel (their output through ``sum_forward``,
         Megatron's g: the fixed-order all-reduce). Attention runs on the
         rank's query heads and the kv heads they read: where the kv heads
         do not split over "model" (fewer than its ranks, or a rank's block
         ends inside a head) the k and v weights are gathered over "model"
         (again ``gather_scatter``) and the rank's kv heads cut out.
  vocab  over "model": the embedding looks up the rank's rows (zeros for
         the others) and sums over "model" (exact: one row is nonzero); the
         head gives the rank's logit columns, masked by global column id;
         the cross-entropy merges per-slice statistics (``losses``, K7's
         partial variant) in rank order.
  EP     "experts" over "model": each rank runs E / model experts on the
         slots routed to them, and the gate-weighted combine's partial
         token sums add over "model" in rank order (``models.moe``).

The other mixers, under the same rules:

  MLA    "heads" over "model": the rank runs its block of the query
         heads, ``Plan._block(n_heads)``, which need not be equal (40
         heads over 16 ranks: 2, 3, 2, 3, ...; 4 over 8: some ranks none,
         which give zeros to g). q_up's and kv_up's columns and o's rows
         carry the heads (head-major), and the rules cut each where its
         flattened dim divides "model", so each is "local" (cut into
         whole heads: the rank's block is its heads), "gather" (cut inside
         a head: gathered over "model" with ``gather_scatter``, whose
         backward reduce-scatters the gradient, then cut to the rank's
         heads) or "whole" (through ``sum_backward``, then cut to them):
         ``Plan.layout``'s ``mla`` key. q_down, kv_down and the two latent
         norms stay whole over "model". Megatron's f goes on the normed
         latents and on the shared RoPE key, which every rank's heads
         read, so the whole leaves before them get the same gradient on
         every model rank; o's output goes through g.
  RG-LRU "inner" over "model": in_x's and in_gate's columns, conv_w's
         columns, ``lam``, the gate blocks (dim 0 of gate_a/gate_x) and
         out's rows are the rank's channels, which must hold whole gate
         blocks. The block input goes through f; everything from in_x to
         the product h * gate is per channel or per gate block, so it runs
         on the rank's channels alone; out is row-parallel, with g.
  xattn  self-attention's layout (the same leaves and kv modes): q of the
         block input through f, k and v the rank's kv heads of the context
         (an input with no gradient: no f), o row-parallel with g, and the
         whole tanh gate after g.
  SSM    "inner" over "model": z's columns, norm_scale and out's rows are
         the rank's heads' channels (a rank's block of d_inner must be
         whole heads); xbc's columns are [x, B, C], whose "inner" cut
         ends at no head boundary, so xbc and conv_w are gathered over
         "model" and cut to the rank's x heads and all of B and C; dt's
         columns, dt_bias, A_log and D stay whole over "model" and each
         rank takes its heads (through f). The block input goes through
         f; the conv, the SSD and the gate run on the rank's heads with
         the whole B and C; the gated norm's row statistic is the ranks'
         sums of squares added both ways (``TP.both``: each rank's
         normed channels feed its own rows of out, so the statistic's
         gradient is partial too); out is row-parallel, with g.

Every cross-rank sum is a fixed-order fold (``core.collectives``), so a
replicated tensor has the same bits on every rank and two runs have the
same bits. The loss of a rank is its own rows' mean: the step sums the
gradients over the batch axes and divides by their ranks
(``launch.steps``). Along "model" the Megatron convention holds: every rank
of a model group computes the same loss, and a tensor the group holds
alike has the same gradient on each of them.

The codebook streams (K > 0, musicgen-medium): the (K, vocab, d) table
has its d cut over the batch axes (FSDP), so the lookup gathers it first;
its vocabulary rows are cut over "model" unpadded, so a rank's rows start
at ``Plan.book0``, not at the head's ``Plan.vocab0`` in the padded
vocabulary. The K streams' rows (zeros off the rank) are summed over
"model" in one fixed-order all-reduce of the stacked (K, rows, seq, d)
tensor, then added in order k = 0 .. K-1 as one device adds them. The K
heads give (B, S, K) rows of the rank's columns to the vocab-parallel
loss.

``Plan`` takes every block kind the training step runs (self-attention,
global, local or MLA, the SSM, the RG-LRU and cross-attention, each with
a dense or MoE FFN, and codebook streams) and refuses the cuts a mixer
cannot run (``Plan.layout``).

Serving (``Plan.for_caches``, ``launch.steps.make_prefill_step`` and
``make_decode_step`` with ``mesh=``) runs every block kind forward only,
each rank on its rows of the batch (``launch.sharding.batch_partition``:
all of them where the batch does not divide the data axes), with the
caches cut as ``launch.sharding.cache_shardings`` cuts them. A cache can
be cut where the weights are whole (SMALL_MODEL_RULES), so each block
follows its cache (``Plan.serve_layout``, keyed on the kind's cache
leaves; a ``Serve`` in the block's ``Hooks``):

  heads  self- or cross-attention's k/v cache cut by kv heads over
         "model": the rank computes q for the query heads of its kv heads
         and k/v for those kv heads (columns of whole weights, or its own
         blocks under TP), writes its cache and attends its heads; under TP
         its o rows and Megatron's g follow, else its head outputs are
         gathered over "model" in rank order for the whole o.
  seq    the cache cut by slots over "model" (the kv heads do not split):
         every rank holds every kv head for its block of slots. The
         prefill runs the attention as the training step does and writes
         the rank's slots (of a local attention's ring, the positions whose
         slots p % ring fall in its block, so a prompt past the window
         wraps over the cut); the decode writes the new key only on the
         rank that holds its slot, each rank takes the partial softmax (max,
         denominator, unnormalised output) of every query head over its
         slots, and the partials merge over "model" in rank order
         (``attention.merge_partials``) before the rank takes its heads for
         o. The decode gathers q over "model" first where q is cut by
         heads. A cross-attention cache cut so holds the rank's image
         tokens, every one visible. MLA's latent is cut so too: the prefill
         writes the rank's slots of the latent (``kv_down`` is whole, so
         every rank computes it) and the decode is a split-KV decode in
         latent space (``mla.mla_decode``: q_c and q_rope gathered, each
         rank's block of heads padded to the largest and the padding
         stripped in rank order where the blocks differ, each head's
         partial over the rank's slots with ``kv_norm`` of its own slots,
         merged, then the rank's heads through W_uv and o). MLA's head
         leaves are cut to the rank's heads as in training
         (``Plan._mla_heads``, forward only).
  channels  the SSM's state cut by heads and its conv window by channels
         of [x, B, C], a block that need not end on a head: the rank's xbc
         and conv_w columns are its conv block (under TP its own blocks;
         whole weights are cut to it), it steps that block, the conv
         outputs are gathered over "model" in rank order and it takes its
         x heads and all of B and C; under TP the gated norm's statistic
         is summed over "model" and out is row-parallel, with whole weights
         the heads' y is gathered before the whole norm and out. The
         RG-LRU's ``h`` and conv window cut by channels, the same block as
         ``inner_tp``'s weights: under TP the rank runs its channels to
         h * gate and out is row-parallel; with whole weights it runs its
         channels' columns (whole gate blocks) and the products are
         gathered before the whole out.
  whole  the cache whole on every model rank: every rank writes it all.

The head's columns are gathered over "model" into the whole vocabulary
(prefill, and a decode that returns logits), or the greedy token is taken
by a (max, global index) merge in rank order with no gather
(``Plan.greedy``), equal to ``torch.argmax`` over the whole row: the
lowest index wins a tie, and NaN counts as the maximum. Codebook streams
give (B, 1, K, columns) logits: gathered on the last dim, or one greedy
merge a stream. The MoE runs EP without the load-balance statistics
(serving drops the aux loss). The cuts a block cannot run are refused
with the reason: heads that do not split, query heads that are not whole
groups of a kv head's, RG-LRU channels that are not whole gate blocks, an
SSM rank's channels that are not whole heads (or more than one group of
B and C with the state cut by heads). Self- and cross-attention refuse
query heads that do not split over "model": K6's GQA needs whole groups of
a kv head's query heads on a rank, and no config reaches that case.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch

from repro_torch.core import collectives as C
from repro_torch.launch.sharding import entry_axes, spec_axes, tree_map
from repro_torch.models import params as P
from repro_torch.models.rglru import N_GATE_BLOCKS, _width
from repro_torch.models.ssm import _dims as _ssm_dims

# MLA's leaves that carry the heads, and the dim that carries them.
MLA_HEAD_LEAVES = (("q_up", 1), ("kv_up", 1), ("o", 0))


def mla_leaf_modes(cfg, mesh, ms: dict):
    """How an MLA block's head leaves (specs ``ms``) reach the rank's
    heads (the module doc): None where none is cut over "model" (every
    rank runs every head), else each leaf's "local", "gather" or
    "whole"."""
    if "model" not in mesh.axis_names or mesh.axis_size("model") == 1:
        return None
    cut = {name: len(ms[name]["w"]) > dim and "model" in entry_axes(ms[name]["w"][dim])
           for name, dim in MLA_HEAD_LEAVES}
    if not any(cut.values()):
        return None
    even = cfg.n_heads % mesh.axis_size("model") == 0
    return {name: "whole" if not c else "local" if even else "gather" for name, c in cut.items()}


@dataclasses.dataclass(frozen=True)
class TP:
    """Megatron's f and g over one mesh axis."""

    mesh: object
    axis: str

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return C.sum_backward(x, self.axis, self.mesh)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return C.sum_forward(y, self.axis, self.mesh)

    def both(self, s: torch.Tensor) -> torch.Tensor:
        """A statistic each rank took over its own channels, summed over
        the axis both ways (the SSM's gated norm)."""
        return C.sum_both(s, self.axis, self.mesh)


@dataclasses.dataclass(frozen=True)
class EP:
    """Expert parallelism: the rank's experts ``[e0, e0 + n)`` of the
    model's, over ``tp.axis`` (``tp`` None: every rank runs all of them);
    ``batch`` the batch axes the load-balance statistics sum over (their
    ranks hold the other rows)."""

    mesh: object
    tp: object
    e0: int
    n: int
    batch: tuple
    data_degree: int


@dataclasses.dataclass(frozen=True)
class Hooks:
    """What one block runs sharded: the mixer's tensor parallelism
    (``attn``: attention, MLA or cross-attention heads, or the RG-LRU's
    channels) and the FFN's, expert parallelism (None where the block runs
    whole on every rank), and in serving its heads or channels and its
    block of the cache (``Serve``)."""

    attn: object = None
    ffn: object = None
    ep: object = None
    serve: object = None


def _gather_batch_dims(x: torch.Tensor, spec: tuple, mesh, batch: tuple) -> torch.Tensor:
    """x with every dim cut over batch axes gathered (FSDP)."""
    for i, e in enumerate(spec):
        axes = entry_axes(e)
        fsdp = tuple(ax for ax in axes if ax in batch)
        if not fsdp:
            continue
        if len(fsdp) != len(axes):
            raise NotImplementedError(f"a dim cut over batch and model axes at once ({e!r})")
        x = C.gather_scatter(x, fsdp, i, mesh)
    return x


@dataclasses.dataclass(frozen=True)
class Serve:
    """How a rank runs one block's prefill and decode (``Plan.serve_block``;
    the module doc). Its weights are already the rank's. ``cache``: how
    its cache is cut over ``axis`` ("heads", "seq", "channels" or
    "whole"); ``q_heads``: the heads the rank runs (attention's, MLA's or
    cross-attention's query heads, or the SSM's heads, its state's block);
    ``cache_heads``: the kv heads its k/v cache holds; ``slots``: the
    global slots its cache holds (a cross-attention cache's image tokens);
    ``channels``: the channels its conv cache holds (the SSM's [x, B, C],
    the RG-LRU's width, whose ``h`` is cut alike); ``gather_heads``: its
    outputs (attention's heads, the SSM's y, the RG-LRU's products) are
    gathered over ``axis`` before the whole o or out; ``q_sizes``: every
    model rank's count of query heads, in rank order, where MLA's decode
    gathers them (the blocks may differ)."""

    mesh: object
    axis: object
    cache: str
    q_heads: tuple = None
    cache_heads: tuple = None
    slots: tuple = None
    channels: tuple = None
    gather_heads: bool = False
    q_sizes: tuple = None

    def gather(self, x: torch.Tensor, dim: int, sizes=None) -> torch.Tensor:
        """The model ranks' blocks of ``x`` along ``dim``, in rank order;
        ``sizes``: each rank's length along ``dim`` where they differ."""
        return C.gather_blocks(x, self.axis, dim, self.mesh, sizes) if self.axis else x

    def rows(self, x: torch.Tensor) -> list:
        """Every model rank's ``x``, in rank order."""
        return C.gather_rows(x, self.axis, self.mesh) if self.axis else [x]


class Plan:
    """The sharded forward's layout: the mesh, every leaf's spec, and the
    axes that matter (those of more than one rank); the serving layout's
    caches from ``for_caches``."""

    def __init__(self, cfg, mesh, specs):
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.cache_specs = self.cache_meta = None
        live = tuple(ax for ax in mesh.axis_names if mesh.axis_size(ax) > 1)
        self.batch = tuple(ax for ax in live if ax in ("pod", "data"))
        self.model = "model" if "model" in live else None
        self.data_degree = math.prod(mesh.axis_size(ax) for ax in self.batch)
        table = specs["embed"]["table"]
        self.vocab_parallel = self.model is not None and self.model in spec_axes(table)
        self.tp = TP(mesh, self.model) if self.model else None
        self.vocab0 = self.book0 = 0
        if self.vocab_parallel:
            n_model, m = mesh.axis_size(self.model), mesh.axis_index(self.model)
            self.vocab0 = m * (P.padded_vocab(cfg.vocab_size) // n_model)
            # the codebook table's rows are the unpadded vocabulary's
            self.book0 = m * (cfg.vocab_size // n_model)
        if cfg.n_codebooks and "head" in specs and self.vocab_parallel != (
                self.model is not None and self.model in spec_axes(specs["head"]["w"])):
            raise NotImplementedError(f"{cfg.name}: the codebook table's {cfg.vocab_size} rows "
                                      "and the heads' padded columns must be cut over 'model' "
                                      "alike")
        for kind, sp in zip(cfg.pattern_layers, specs["layers"]):
            self.layout(sp, kind)  # a cut a block cannot run refuses here

    def for_caches(self, meta) -> "Plan":
        """This plan with the serving layout's caches: ``meta``, the global
        caches of one batch and cache length (``models.make_caches`` on the
        meta device), and their specs (``launch.sharding.
        cache_shardings``)."""
        from repro_torch.launch.sharding import cache_shardings

        plan = copy.copy(self)
        plan.cache_meta = meta
        plan.cache_specs = cache_shardings(meta, self.cfg, self.mesh)
        return plan

    # ------------------------------ parameters -------------------------------

    def gather(self, tree, specs):
        """Every leaf of ``tree`` with its batch-axis dims gathered."""
        return tree_map(lambda x, s: _gather_batch_dims(x, s, self.mesh, self.batch), tree,
                        specs)

    def _model_cut(self, spec: tuple, dim: int) -> bool:
        return self.model is not None and len(spec) > dim and self.model in entry_axes(spec[dim])

    def _heads_split(self) -> int:
        """The query heads a model rank holds under self- or
        cross-attention's tensor parallelism; refuses where they do not
        split (the module doc)."""
        n_model = self.mesh.axis_size(self.model)
        if self.cfg.n_heads % n_model:
            raise NotImplementedError(f"{self.cfg.n_heads} query heads do not split over "
                                      f"{n_model} model ranks")
        return self.cfg.n_heads // n_model

    def _rec_layout(self, ms: dict) -> bool:
        """Whether the RG-LRU's channels are cut over "model" (``inner_tp``):
        every channel leaf alike, each rank's channels whole gate blocks."""
        cuts = {name: self._model_cut(s, dim) for name, s, dim in (
            ("in_x", ms["in_x"]["w"], 1), ("in_gate", ms["in_gate"]["w"], 1),
            ("conv_w", ms["conv_w"], 1), ("lam", ms["lam"], 0), ("out", ms["out"]["w"], 0),
            ("gate_a", ms["gate_a"], 0), ("gate_x", ms["gate_x"], 0))}
        if len(set(cuts.values())) == 1:
            return cuts["in_x"]
        w, n_model = _width(self.cfg), self.mesh.axis_size(self.model)
        channels = {v for k, v in cuts.items() if not k.startswith("gate")}
        if channels == {True} and not (cuts["gate_a"] or cuts["gate_x"]):
            raise NotImplementedError(
                f"{self.cfg.name}: a model rank's {w // n_model} RG-LRU channels do not hold "
                f"whole gate blocks of {w // N_GATE_BLOCKS} ({N_GATE_BLOCKS} blocks over "
                f"{n_model} model ranks), so the gate blocks stay whole while the channels "
                "are cut")
        raise NotImplementedError(f"the RG-LRU's channel leaves must be cut over 'model' "
                                  f"alike (cut: {sorted(k for k, v in cuts.items() if v)})")

    def _ssm_layout(self, ms: dict) -> bool:
        """Whether the SSM's channels are cut over "model" (``inner_tp``):
        z's and xbc's columns, conv_w's, norm_scale and out's rows alike,
        each rank's block of d_inner whole heads of the one group of B and
        C (xbc's block need not end on a head: ``Plan.block`` gathers
        it)."""
        cuts = {name: self._model_cut(s, dim) for name, s, dim in (
            ("z", ms["z"]["w"], 1), ("xbc", ms["xbc"]["w"], 1), ("conv_w", ms["conv_w"], 1),
            ("norm_scale", ms["norm_scale"], 0), ("out", ms["out"]["w"], 0))}
        if len(set(cuts.values())) > 1:
            raise NotImplementedError(f"the SSM's channel leaves must be cut over 'model' alike "
                                      f"(cut: {sorted(k for k, v in cuts.items() if v)})")
        if not cuts["z"]:
            return False
        s, d_in, _, _ = _ssm_dims(self.cfg)
        n_model = self.mesh.axis_size(self.model)
        if (d_in // n_model) % s.headdim:
            raise NotImplementedError(f"{self.cfg.name}: a model rank's {d_in // n_model} SSM "
                                      f"channels ({d_in} over {n_model} model ranks) are not "
                                      f"whole heads of {s.headdim}")
        if s.n_groups != 1:
            raise NotImplementedError(f"{self.cfg.name}: the SSM's tensor parallelism runs one "
                                      f"group of B and C, not {s.n_groups}")
        return True

    def layout(self, specs: dict, kind: str) -> dict:
        """How a block of ``kind`` with these specs runs (no tensors):
        ``attn_tp`` (its attention, MLA or cross-attention heads split over
        "model"), ``inner_tp`` (the SSM's or the RG-LRU's channels split
        over it),
        ``kv`` ("local": the rank's block is its kv heads; "gather": k/v
        gathered over "model", the rank's heads cut out; "whole": k/v held
        whole, the rank's heads cut out; None without TP or without k/v),
        the kv head range, ``mla`` (MLA's head leaves: ``mla_leaf_modes``,
        None where every rank runs every head), ``ffn_tp``, and ``ep``
        ("model": experts split over it; "batch": the load-balance sums
        over the batch axes only; None)."""
        cfg, ms = self.cfg, specs["mix"]
        out = {"attn_tp": False, "inner_tp": False, "kv": None, "kv_heads": None, "mla": None,
               "ffn_tp": False, "ep": None}
        if kind == "ssm":
            out["inner_tp"] = self._ssm_layout(ms)
        elif kind == "rec":
            out["inner_tp"] = self._rec_layout(ms)
        elif kind != "xattn" and cfg.mla is not None:
            out["mla"] = mla_leaf_modes(cfg, self.mesh, ms)
            out["attn_tp"] = out["mla"] is not None
        else:
            out.update(self._attn_layout(ms))
        return self._ffn_layout(specs, out)

    def _attn_layout(self, ms: dict) -> dict:
        """Self- or cross-attention's ``attn_tp``, ``kv`` and kv heads."""
        cfg, mesh = self.cfg, self.mesh
        attn_tp = self._model_cut(ms["q"]["w"], 1)
        if attn_tp != self._model_cut(ms["o"]["w"], 0):
            raise NotImplementedError("q and o must be cut over 'model' alike")
        out = {"attn_tp": attn_tp}
        if attn_tp:
            m, n_model = mesh.axis_index(self.model), mesh.axis_size(self.model)
            hq = self._heads_split()
            group = cfg.n_heads // cfg.n_kv_heads
            out["kv_heads"] = (m * hq // group, (m * hq + hq - 1) // group + 1)
            cuts = {self._model_cut(ms[n]["w"], 1) for n in ("k", "v")}
            if len(cuts) > 1:
                raise NotImplementedError("k and v must be cut over 'model' alike")
            cut = cuts.pop()
            out["kv"] = ("local" if cut and cfg.n_kv_heads % n_model == 0 else
                         "gather" if cut else "whole")
        elif any(self._model_cut(ms[n]["w"], 1) for n in ("k", "v")):
            raise NotImplementedError("k/v cut over 'model' while the query heads are not")
        return out

    def _ffn_layout(self, specs: dict, out: dict) -> dict:
        """``out`` with the FFN's ``ffn_tp`` and ``ep``."""
        cfg = self.cfg
        if "ffn" in specs:
            fs = specs["ffn"]
            if cfg.moe is not None:
                out["ep"] = ("model" if self._model_cut(fs["up"], 0) else
                             "batch" if self.batch else None)
            else:
                cuts = {self._model_cut(fs["up"]["w"], 1), self._model_cut(fs["down"]["w"], 0)}
                if len(cuts) > 1:
                    raise NotImplementedError("up and down must be cut over 'model' alike")
                out["ffn_tp"] = cuts.pop()
        return out

    def block(self, kind: str, p: dict, specs: dict):
        """A block's weights as its ranks use them, and its ``Hooks``."""
        cfg, mesh = self.cfg, self.mesh
        lay = self.layout(specs, kind)
        p = self.gather(p, specs)
        mix = dict(p["mix"])
        if lay["kv"] in ("gather", "whole"):
            lo, hi = lay["kv_heads"]
            for name in ("k", "v"):
                # gathered over "model" (cut) or used in part by each rank
                # (whole): either way the gradients of the ranks add up
                w = mix[name]["w"]
                w = (C.gather_scatter(w, self.model, 1, mesh) if lay["kv"] == "gather"
                     else C.sum_backward(w, self.model, mesh))
                mix[name] = {"w": w[:, lo * cfg.d_head:hi * cfg.d_head]}
        if kind == "ssm" and lay["inner_tp"]:
            mix = self._ssm_heads(mix)
        if lay["mla"] is not None:
            mix = self._mla_heads(mix, lay["mla"])
        p = dict(p, mix=mix)
        ep = None
        if lay["ep"] == "model":
            n = cfg.moe.n_experts // mesh.axis_size(self.model)
            ep = EP(mesh, self.tp, mesh.axis_index(self.model) * n, n, self.batch,
                    self.data_degree)
        elif lay["ep"] == "batch":
            ep = EP(mesh, None, 0, cfg.moe.n_experts, self.batch, self.data_degree)
        return p, Hooks(attn=self.tp if lay["attn_tp"] or lay["inner_tp"] else None,
                        ffn=self.tp if lay["ffn_tp"] else None, ep=ep)

    def _ssm_heads(self, mix: dict) -> dict:
        """An SSM block's leaves as the rank's heads use them (the module
        doc): xbc and conv_w gathered over "model" (their gradients the
        ranks' sum, cut back to the rank's block) and cut to the rank's x
        channels, then all of B and C; dt's columns, dt_bias, A_log and D
        (whole over "model", each rank using its heads' part) through
        ``sum_backward``."""
        s, d_in, nh, _ = _ssm_dims(self.cfg)
        n = nh // self.mesh.axis_size(self.model)
        h0 = self.mesh.axis_index(self.model) * n
        c0, c1 = h0 * s.headdim, (h0 + n) * s.headdim

        def x_b_c(w):
            w = C.gather_scatter(w, self.model, 1, self.mesh)
            return torch.cat([w[:, c0:c1], w[:, d_in:]], 1)

        def heads(w):
            return C.sum_backward(w, self.model, self.mesh)[..., h0:h0 + n]

        return dict(mix, xbc={"w": x_b_c(mix["xbc"]["w"])}, conv_w=x_b_c(mix["conv_w"]),
                    dt={"w": heads(mix["dt"]["w"])}, dt_bias=heads(mix["dt_bias"]),
                    A_log=heads(mix["A_log"]), D=heads(mix["D"]))

    def _mla_heads(self, mix: dict, modes: dict) -> dict:
        """An MLA block's head leaves cut to the rank's query heads
        (``modes``: ``mla_leaf_modes``; the module doc). Serving runs the
        same ops under ``no_grad``: the gathers forward only."""
        m = self.cfg.mla
        heads = self._block(self.cfg.n_heads, True)
        widths = {"q_up": m.qk_nope_dim + m.qk_rope_dim, "kv_up": m.qk_nope_dim + m.v_head_dim,
                  "o": m.v_head_dim}  # one head's columns (rows of o)
        out = dict(mix)
        for name, dim in MLA_HEAD_LEAVES:
            if modes[name] != "local":
                out[name] = {"w": self._mla_leaf(mix[name]["w"], dim, modes[name], heads,
                                                 widths[name])}
        return out

    def _mla_leaf(self, w: torch.Tensor, dim: int, mode: str, heads: tuple,
                  width: int) -> torch.Tensor:
        """One head leaf ("gather" or "whole") as the rank uses it: the
        heads ``heads`` of ``width`` along ``dim``."""
        if mode == "gather":
            w = C.gather_scatter(w, self.model, dim, self.mesh)
        else:  # each rank uses its heads' part: the gradients add up
            w = C.sum_backward(w, self.model, self.mesh)
        return w.narrow(dim, heads[0] * width, (heads[1] - heads[0]) * width)

    # ------------------------------- vocabulary -------------------------------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: the rank's rows, zeros elsewhere,
        summed over "model" (one nonzero row a token: exact). With codebook
        streams, ``_embed_books``."""
        if self.cfg.n_codebooks:
            return self._embed_books(table, tokens)
        if not self.vocab_parallel:
            return table[tokens]
        return self.tp.exit(self._rows(table, tokens, self.vocab0))

    def _rows(self, table: torch.Tensor, tokens: torch.Tensor, row0: int) -> torch.Tensor:
        """The rows of ``tokens`` in a table whose first row is global row
        ``row0``, zeros for the tokens outside it."""
        local = tokens - row0
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(hit, local, 0)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))

    def _embed_books(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S, K) tokens -> the K streams' rows added in order k = 0 ..
        K-1, in the table's dtype (the module doc): the table's d gathered
        over the batch axes; under vocab TP each stream's rows of the
        rank's block (from ``book0``), the stacked streams summed over
        "model" in one fixed-order all-reduce."""
        table = self.gather(table, self.specs["embed"]["table"])
        books = range(self.cfg.n_codebooks)
        if self.vocab_parallel:
            rows = self.tp.exit(torch.stack([self._rows(table[k], tokens[..., k], self.book0)
                                             for k in books]))
        else:
            rows = [table[k][tokens[..., k]] for k in books]
        h = rows[0]
        for k in books[1:]:
            h = h + rows[k]
        return h

    def head_input(self, h: torch.Tensor) -> torch.Tensor:
        """The head's input: every model rank's logit columns read it, so
        its gradient is their sum."""
        return self.tp.enter(h) if self.vocab_parallel else h

    # -------------------------------- serving ---------------------------------

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a global batch: its block over the batch axes
        where the batch divides them, every row where it does not
        (``launch.sharding.batch_partition``)."""
        from repro_torch.launch.sharding import _degree_and_index

        deg, idx = _degree_and_index(self.mesh, self.batch)
        if deg == 1 or x.shape[0] % deg:
            return x
        n = x.shape[0] // deg
        return x[idx * n:(idx + 1) * n]

    def serve_layout(self, i: int) -> dict:
        """How block ``i`` serves with the caches of ``for_caches`` (the
        module doc): ``layout``'s keys and ``Serve``'s fields (``cache``,
        ``q_heads``, ``cache_heads``, ``slots``, ``channels``, global
        ranges with hi excluded, and ``gather_heads``), keyed on the
        block's cache leaves. Refuses the cuts a block cannot run."""
        if self.cache_specs is None:
            raise ValueError("the serving layout needs the caches (Plan.for_caches)")
        cfg = self.cfg
        kind = cfg.pattern_layers[i]
        lay = dict(self.layout(self.specs["layers"][i], kind), cache="whole", q_heads=None,
                   cache_heads=None, slots=None, channels=None, gather_heads=False,
                   q_sizes=None)
        cs, meta = self.cache_specs["layers"][i], self.cache_meta["layers"][i]
        if kind == "ssm":
            return self._serve_ssm(lay, cs)
        if kind == "rec":
            return self._serve_rec(lay, cs)
        if kind != "xattn" and cfg.mla is not None:
            cut = self._model_cut(cs["ckv"], 1)
            return dict(lay, cache="seq" if cut else "whole",
                        q_heads=self._block(cfg.n_heads, lay["attn_tp"]),
                        q_sizes=tuple(b - a for a, b in self._blocks(cfg.n_heads))
                        if lay["attn_tp"] else None,
                        slots=self._block(meta["ckv"].shape[1], cut))
        return self._serve_attn(lay, cs, meta["k"].shape[1])

    def _block(self, n: int, cut: bool) -> tuple:
        """The rank's block of ``n`` along a dim cut over "model", or all of
        it."""
        if not cut:
            return (0, n)
        return self._blocks(n)[self.mesh.axis_index(self.model)]

    def _blocks(self, n: int) -> list:
        """Every model rank's block of ``n``, in rank order: from m n / P
        to (m + 1) n / P, rounded down (unequal where P does not divide
        n)."""
        n_model = self.mesh.axis_size(self.model)
        return [(m * n // n_model, (m + 1) * n // n_model) for m in range(n_model)]

    def _serve_attn(self, lay: dict, cs: dict, n_slots: int) -> dict:
        """Self- or cross-attention's serving layout: its k/v cache cut by
        kv heads ("heads"), by slots ("seq": a cross-attention cache's image
        tokens) or "whole", and the rank's query heads."""
        cfg = self.cfg
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        group = h // hkv
        cache = ("heads" if self._model_cut(cs["k"], 2) else
                 "seq" if self._model_cut(cs["k"], 1) else "whole")
        cache_heads = self._block(hkv, cache == "heads")
        if lay["attn_tp"]:
            q_heads = self._block(h, True)
            if cache == "heads" and q_heads != (cache_heads[0] * group, cache_heads[1] * group):
                raise NotImplementedError("the query heads' block and the cache's kv heads "
                                          "are cut apart over 'model'")
        elif cache == "heads":
            q_heads = (cache_heads[0] * group, cache_heads[1] * group)
        else:
            q_heads = (0, h)
        n_q = q_heads[1] - q_heads[0]
        whole_groups = n_q % group == 0 and q_heads[0] % group == 0
        in_one_group = group % n_q == 0 and q_heads[0] // group == (q_heads[1] - 1) // group
        if not (whole_groups or in_one_group):
            raise NotImplementedError(f"{n_q} query heads a rank from head {q_heads[0]} do not "
                                      f"map onto whole groups of {group}")
        return dict(lay, cache=cache, q_heads=q_heads, cache_heads=cache_heads,
                    slots=self._block(n_slots, cache == "seq"),
                    gather_heads=not lay["attn_tp"] and q_heads != (0, h))

    def _serve_ssm(self, lay: dict, cs: dict) -> dict:
        """The SSM's serving layout: its state cut by heads, its conv cache
        by channels of [x, B, C] (a block that need not end on a head:
        each rank steps its block of the conv and the outputs are gathered
        over "model"); where the weights are whole, the heads' y gathered
        before the whole norm and out."""
        s, _, nh, conv_dim = _ssm_dims(self.cfg)
        conv_cut, heads_cut = self._model_cut(cs["conv"], 2), self._model_cut(cs["state"], 1)
        if lay["inner_tp"] and not (conv_cut and heads_cut):
            raise NotImplementedError("the SSM's tensor parallelism needs its conv and state "
                                      "caches cut over 'model' as its channels are")
        if heads_cut and s.n_groups != 1:
            raise NotImplementedError(f"{self.cfg.name}: the SSM's state cut by heads runs one "
                                      f"group of B and C, not {s.n_groups}; a model axis the "
                                      "heads do not divide keeps the state whole and serves it")
        return dict(lay, cache="channels" if conv_cut or heads_cut else "whole",
                    q_heads=self._block(nh, heads_cut), channels=self._block(conv_dim, conv_cut),
                    gather_heads=heads_cut and not lay["inner_tp"])

    def _serve_rec(self, lay: dict, cs: dict) -> dict:
        """The RG-LRU's serving layout: ``h`` and the conv cache cut by
        channels, the same block as ``inner_tp``'s weights; where the
        weights are whole the rank runs its channels (whole gate blocks)
        and their products are gathered before the whole out."""
        w = _width(self.cfg)
        cut = self._model_cut(cs["h"], 1)
        if cut != self._model_cut(cs["conv"], 2) or (lay["inner_tp"] and not cut):
            raise NotImplementedError("the RG-LRU's h and conv caches must be cut over 'model' "
                                      "as its channels are")
        c0, c1 = self._block(w, cut)
        bs = w // N_GATE_BLOCKS
        if cut and not lay["inner_tp"] and (c0 % bs or (c1 - c0) % bs):
            raise NotImplementedError(
                f"{self.cfg.name}: a model rank's {c1 - c0} RG-LRU channels do not hold whole "
                f"gate blocks of {bs}; a model axis that divides the {N_GATE_BLOCKS} gate blocks "
                "serves it")
        return dict(lay, cache="channels" if cut else "whole", channels=(c0, c1),
                    gather_heads=cut and not lay["inner_tp"])

    def serve_block(self, i: int, p: dict):
        """Block ``i``'s weights as the serving rank uses them (FSDP
        gathered; cut to the heads, channels or conv block of its
        ``Serve``) and its ``Hooks`` (TP, EP and the ``Serve``)."""
        cfg, mesh = self.cfg, self.mesh
        kind = cfg.pattern_layers[i]
        lay = self.serve_layout(i)
        specs = self.specs["layers"][i]
        p = self.gather(p, specs)
        mix = dict(p["mix"])
        if kind == "ssm":
            mix = self._serve_ssm_leaves(mix, lay)
        elif kind == "rec":
            mix = self._serve_rec_leaves(mix, lay)
        elif kind == "xattn" or cfg.mla is None:
            mix = self._serve_attn_leaves(mix, lay, specs["mix"])
        elif lay["mla"] is not None:
            mix = self._mla_heads(mix, lay["mla"])
        ep = None
        if lay["ep"] == "model":
            n = cfg.moe.n_experts // mesh.axis_size(self.model)
            ep = EP(mesh, self.tp, mesh.axis_index(self.model) * n, n, (), 1)
        serve = Serve(mesh, self.model, lay["cache"], lay["q_heads"], lay["cache_heads"],
                      lay["slots"], lay["channels"], lay["gather_heads"], lay["q_sizes"])
        return dict(p, mix=mix), Hooks(attn=self.tp if lay["attn_tp"] or lay["inner_tp"] else None,
                                       ffn=self.tp if lay["ffn_tp"] else None, ep=ep, serve=serve)

    def _serve_attn_leaves(self, mix: dict, lay: dict, ms: dict) -> dict:
        """q cut to the rank's query heads (whole weights), k and v to its
        cache's kv heads (gathered over "model" where cut otherwise)."""
        d = self.cfg.d_head
        (q0, q1), (c0, c1) = lay["q_heads"], lay["cache_heads"]
        if not lay["attn_tp"]:
            mix["q"] = {"w": mix["q"]["w"][:, q0 * d:q1 * d]}
        for name in ("k", "v"):
            w = mix[name]["w"]
            if self._model_cut(ms[name]["w"], 1):
                if lay["kv"] == "local" and lay["cache"] == "heads":
                    continue  # the rank's block is its cache's kv heads
                w = C.gather_blocks(w, self.model, 1, self.mesh)
            mix[name] = {"w": w[:, c0 * d:c1 * d]}
        return mix

    def _serve_ssm_leaves(self, mix: dict, lay: dict) -> dict:
        """dt's columns, dt_bias, A_log and D (whole over "model") cut to
        the rank's heads; where the weights are whole, xbc's and conv_w's
        columns cut to its conv block (under TP its blocks are that block
        already)."""
        h0, h1 = lay["q_heads"]
        if not lay["inner_tp"]:
            c0, c1 = lay["channels"]
            mix["xbc"] = {"w": mix["xbc"]["w"][:, c0:c1]}
            mix["conv_w"] = mix["conv_w"][:, c0:c1]
        mix["dt"] = {"w": mix["dt"]["w"][:, h0:h1]}
        for name in ("dt_bias", "A_log", "D"):
            mix[name] = mix[name][h0:h1]
        return mix

    def _serve_rec_leaves(self, mix: dict, lay: dict) -> dict:
        """Where the weights are whole, every channel leaf but out cut to the
        rank's channels and gate blocks (under TP they are its own)."""
        if lay["inner_tp"]:
            return mix
        c0, c1 = lay["channels"]
        bs = _width(self.cfg) // N_GATE_BLOCKS
        out = dict(mix, in_x={"w": mix["in_x"]["w"][:, c0:c1]},
                   in_gate={"w": mix["in_gate"]["w"][:, c0:c1]}, conv_w=mix["conv_w"][:, c0:c1],
                   lam=mix["lam"][c0:c1])
        for name in ("gate_a", "gate_x"):
            out[name] = mix[name][c0 // bs:c1 // bs]
        return out

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The rank's logit columns gathered over "model" into the whole
        (padded) vocabulary, in rank order."""
        if not self.vocab_parallel:
            return logits
        return C.gather_blocks(logits, self.model, logits.ndim - 1, self.mesh)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token (int32, the last dim dropped) of the rank's
        logit columns: its own argmax over its columns below
        ``vocab_size``, then a (max, global index) merge over "model" in
        rank order (one gather of two f64 a row, no gather of the
        vocabulary). A later rank wins only with a larger value, or a NaN
        over a number: ``torch.argmax`` over the whole row."""
        if not self.vocab_parallel:
            return torch.argmax(logits[..., :self.cfg.vocab_size], -1).to(torch.int32)
        valid = max(0, min(logits.shape[-1], self.cfg.vocab_size - self.vocab0))
        if valid:
            x = logits[..., :valid]
            idx = torch.argmax(x, -1, keepdim=True)
            val = torch.gather(x, -1, idx)
        else:
            idx = torch.zeros(logits.shape[:-1] + (1,), dtype=torch.int64, device=logits.device)
            val = torch.full(idx.shape, float("-inf"), device=logits.device)
        pair = torch.cat([val.to(torch.float64), (idx + self.vocab0).to(torch.float64)], -1)
        rows = C.gather_rows(pair, self.model, self.mesh)
        best = rows[0]
        for row in rows[1:]:
            v, b = row[..., 0], best[..., 0]
            take = (v > b) | (torch.isnan(v) & ~torch.isnan(b))
            best = torch.where(take[..., None], row, best)
        return best[..., 1].to(torch.int32)
