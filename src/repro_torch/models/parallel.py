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

Every cross-rank sum is a fixed-order fold (``core.collectives``), so a
replicated tensor has the same bits on every rank and two runs have the
same bits. The loss of a rank is its own rows' mean: the step sums the
gradients over the batch axes and divides by their ranks
(``launch.steps``). Along "model" the Megatron convention holds: every rank
of a model group computes the same loss, and a tensor the group holds
alike has the same gradient on each of them.

``Plan`` checks that the config's blocks are ones the sharded step runs
(self-attention, global or local, without MLA, and a dense or MoE FFN; no
codebook streams); the others refuse with that reason.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import collectives as C
from repro_torch.launch.sharding import entry_axes, spec_axes, tree_map
from repro_torch.models import params as P


@dataclasses.dataclass(frozen=True)
class TP:
    """Megatron's f and g over one mesh axis."""

    mesh: object
    axis: str

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return C.sum_backward(x, self.axis, self.mesh)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return C.sum_forward(y, self.axis, self.mesh)


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
    """What one block runs sharded: attention and FFN tensor parallelism,
    expert parallelism (None where the block runs whole on every rank)."""

    attn: object = None
    ffn: object = None
    ep: object = None


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


class Plan:
    """The sharded forward's layout: the mesh, every leaf's spec, and the
    axes that matter (those of more than one rank)."""

    def __init__(self, cfg, mesh, specs):
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        live = tuple(ax for ax in mesh.axis_names if mesh.axis_size(ax) > 1)
        self.batch = tuple(ax for ax in live if ax in ("pod", "data"))
        self.model = "model" if "model" in live else None
        self.data_degree = math.prod(mesh.axis_size(ax) for ax in self.batch)
        bad = [k for k in cfg.pattern_layers if k not in ("attn", "local_attn")]
        if bad or cfg.mla is not None or cfg.n_codebooks:
            what = (f"block kinds {sorted(set(bad))}" if bad else
                    "MLA" if cfg.mla is not None else "codebook streams")
            raise NotImplementedError(f"the sharded step runs self-attention blocks with a "
                                      f"dense or MoE FFN; {cfg.name} has {what}")
        table = specs["embed"]["table"]
        self.vocab_parallel = self.model is not None and self.model in spec_axes(table)
        self.tp = TP(mesh, self.model) if self.model else None
        self.vocab0 = 0
        if self.vocab_parallel:
            n = P.padded_vocab(cfg.vocab_size) // mesh.axis_size(self.model)
            self.vocab0 = mesh.axis_index(self.model) * n

    # ------------------------------ parameters -------------------------------

    def gather(self, tree, specs):
        """Every leaf of ``tree`` with its batch-axis dims gathered."""
        return tree_map(lambda x, s: _gather_batch_dims(x, s, self.mesh, self.batch), tree,
                        specs)

    def _model_cut(self, spec: tuple, dim: int) -> bool:
        return self.model is not None and len(spec) > dim and self.model in entry_axes(spec[dim])

    def layout(self, specs: dict) -> dict:
        """How a block with these specs runs (no tensors): ``attn_tp``
        (its heads split over "model"), ``kv`` ("local": the rank's block
        is its kv heads; "gather": k/v gathered over "model", the rank's
        heads cut out; "whole": k/v held whole, the rank's heads cut out;
        None without TP), the kv head range, ``ffn_tp``, and ``ep``
        ("model": experts split over it; "batch": the load-balance sums
        over the batch axes only; None)."""
        cfg, mesh = self.cfg, self.mesh
        ms = specs["mix"]
        attn_tp = self._model_cut(ms["q"]["w"], 1)
        if attn_tp != self._model_cut(ms["o"]["w"], 0):
            raise NotImplementedError("q and o must be cut over 'model' alike")
        out = {"attn_tp": attn_tp, "kv": None, "kv_heads": None, "ffn_tp": False, "ep": None}
        if attn_tp:
            m, n_model = mesh.axis_index(self.model), mesh.axis_size(self.model)
            if cfg.n_heads % n_model:
                raise NotImplementedError(f"{cfg.n_heads} query heads do not split over "
                                          f"{n_model} model ranks")
            hq = cfg.n_heads // n_model
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
        lay = self.layout(specs)
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
        p = dict(p, mix=mix)
        ep = None
        if lay["ep"] == "model":
            n = cfg.moe.n_experts // mesh.axis_size(self.model)
            ep = EP(mesh, self.tp, mesh.axis_index(self.model) * n, n, self.batch,
                    self.data_degree)
        elif lay["ep"] == "batch":
            ep = EP(mesh, None, 0, cfg.moe.n_experts, self.batch, self.data_degree)
        return p, Hooks(attn=self.tp if lay["attn_tp"] else None,
                        ffn=self.tp if lay["ffn_tp"] else None, ep=ep)

    # ------------------------------- vocabulary -------------------------------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: the rank's rows, zeros elsewhere,
        summed over "model" (one nonzero row a token: exact)."""
        if not self.vocab_parallel:
            return table[tokens]
        local = tokens - self.vocab0
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(hit, local, 0)]
        rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        return self.tp.exit(rows)

    def head_input(self, h: torch.Tensor) -> torch.Tensor:
        """The head's input: every model rank's logit columns read it, so
        its gradient is their sum."""
        return self.tp.enter(h) if self.vocab_parallel else h
