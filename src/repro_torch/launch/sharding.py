"""Logical axes -> mesh axes: the sharding rules, and the blocks they cut.

Port of ``repro/launch/sharding.py``. Parameters carry logical axis names
(``models.model.param_axes``); a rules dict maps them onto mesh axes. The
default is the hybrid of production LM stacks:

  tensor-parallel  : ffn / heads / kv_heads / experts / inner / vocab -> "model"
  FSDP (ZeRO-3)    : embed (the d_model dim of every matrix) -> "data":
                     each rank stores its block, gathers a block's weights
                     before using them and reduce-scatters their gradients
                     (``models.parallel``); the optimizer state mirrors the
                     parameters' blocks
  pod axis         : data parallelism (BIG_MODEL_RULES also shards "embed"
                     over it)

A spec is the port's own stand-in for the reference's ``PartitionSpec``: a
tuple with one entry per dim, each None, a mesh axis name or a tuple of
names (the first the major one), trailing Nones dropped by ``spec_for``,
so ``tuple(P(...))`` of the reference equals it entry for entry. The
reference's ``NamedSharding`` (a spec on a mesh) has no counterpart: the
functions here take the mesh beside the spec. ``block_of`` cuts a whole
tensor into a rank's block, ``shard_tree`` a whole tree (the JAX package's
parameters carried across), and ``gather_whole`` gathers a block back.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import collectives as C
from repro_torch.launch.mesh import batch_axes

DEFAULT_RULES: dict = {
    "vocab": "model",
    "embed": "data",
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "inner": "model",
}

# Pure TP (no FSDP): small models whose per-layer gathers cost more than
# the replicated storage.
TP_ONLY_RULES = dict(DEFAULT_RULES, embed=None)

# 100B+ models (dbrx): FSDP over the pod axis as well; on a mesh without
# "pod" the absent axis is skipped.
BIG_MODEL_RULES = dict(DEFAULT_RULES, embed=("pod", "data"))

# <3B models: DP + FSDP only; experts keep EP, vocab the sharded CE head.
SMALL_MODEL_RULES = dict(DEFAULT_RULES, ffn=None, heads=None, kv_heads=None, inner=None)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (tensors, axes
    tuples or specs), with matching trees in ``rest``; dict keys keep
    their order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``reduce.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def spec_for(axes, rules: dict, mesh, shape=None) -> tuple:
    """One logical-axes tuple -> a spec (mesh axes absent from the mesh
    skipped, each mesh axis used once). With ``shape``, a dim whose size
    the candidate axes' product does not divide stays whole."""
    if axes is None:
        return ()
    used: set = set()
    parts: list = []
    for i, name in enumerate(axes):
        m = rules.get(name) if name else None
        if isinstance(m, str):
            m = (m,)
        cand = tuple(ax for ax in (m or ()) if ax in mesh.axis_names and ax not in used)
        deg = math.prod(mesh.axis_size(ax) for ax in cand)
        if cand and (shape is None or shape[i] % deg == 0):
            parts.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def batch_partition(mesh, global_batch: int):
    """The batch dim's spec entry over the data axes, or None when the
    batch does not divide them."""
    ba = batch_axes(mesh)
    deg = math.prod(mesh.axis_size(ax) for ax in ba)
    if not ba or global_batch % deg != 0:
        return None
    return ba if len(ba) > 1 else ba[0]


def param_shardings(axes_tree, mesh, rules=None, shapes_tree=None):
    """An axes tree (and optionally a tree of tensors or shapes like it) ->
    a tree of specs."""
    rules = rules or DEFAULT_RULES
    if shapes_tree is None:
        return tree_map(lambda a: spec_for(a, rules, mesh), axes_tree)
    return tree_map(lambda a, s: spec_for(a, rules, mesh, tuple(s.shape)), axes_tree,
                    shapes_tree)


def like_tree(tree, sharding_tree):
    """A spec tree laid over a tree of the same structure (the optimizer's
    moments mirror the parameters)."""
    return tree_map(lambda _, s: s, tree, sharding_tree)


def batch_spec(mesh, extra: tuple = ()) -> tuple:
    ba = batch_axes(mesh)
    return (ba if len(ba) > 1 else (ba[0] if ba else None),) + tuple(extra)


def cache_shardings(caches, cfg, mesh):
    """A spec tree for decode caches (``models.make_caches``), one spec of
    the leaf's rank per leaf, keyed on the leaf's name:

      k/v:   (B, S, Hkv, D) -> (batch, None, model*, None)
      ckv:   (B, S, R)      -> (batch, None, None)  [MLA latent]
      conv:  (B, K-1, C)    -> (batch, None, model)
      state: (B, H, P, N)   -> (batch, model, None, None)  [SSD]
      h:     (B, W)         -> (batch, model)  [RG-LRU]
      slot_pos: replicated
    (* model only where the head count divides it; else the sequence dim.)
    The reference stacks unit caches on a leading axis; here each layer is
    its own entry, so its specs lack that leading None."""
    ba = batch_axes(mesh)
    b = ba if len(ba) > 1 else (ba[0] if ba else None)
    model_n = mesh.axis_size("model")
    data_n = math.prod(mesh.axis_size(ax) for ax in ba)

    def leaf_spec(name, leaf):
        shape = tuple(leaf.shape)
        bspec = b if (shape and shape[0] % data_n == 0) else None

        def mdl(i):
            return "model" if shape[i] % model_n == 0 else None

        if name in ("k", "v") and len(shape) == 4:
            s = (bspec, None, "model", None) if mdl(2) else (bspec, mdl(1), None, None)
        elif name == "ckv":
            s = (bspec, mdl(1), None)
        elif name == "conv":
            s = (bspec, None, mdl(2))
        elif name == "state":
            s = (bspec, mdl(1), None, None)
        elif name == "h":
            s = (bspec, mdl(1))
        elif name == "slot_pos":
            s = (None,) * len(shape)
        else:
            s = (bspec,) + (None,) * (len(shape) - 1)
        return tuple(s[:len(shape)]) + (None,) * (len(shape) - len(s))

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return leaf_spec(name, tree)

    return walk(caches)


# ------------------------------ blocks of tensors ------------------------------


def entry_axes(entry) -> tuple:
    """A spec entry's mesh axes: None -> (), "data" -> ("data",)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec cuts a dim over, in spec order."""
    return tuple(ax for e in spec for ax in entry_axes(e))


def _degree_and_index(mesh, axes: tuple) -> tuple:
    deg, idx = 1, 0
    for ax in axes:  # the first axis the major one
        n = mesh.axis_size(ax)
        deg, idx = deg * n, idx * n + mesh.axis_index(ax)
    return deg, idx


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        deg, _ = _degree_and_index(mesh, entry_axes(e))
        if out[i] % deg:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {deg} ranks "
                             f"({e!r})")
        out[i] //= deg
    return tuple(out)


def block_of(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's block of a whole tensor under ``spec`` (a view)."""
    local_shape(full.shape, spec, mesh)  # refuses a dim that does not split
    out = full
    for i, e in enumerate(spec):
        deg, idx = _degree_and_index(mesh, entry_axes(e))
        if deg > 1:
            n = full.shape[i] // deg
            out = out.narrow(i, idx * n, n)
    return out


def shard_tree(tree, specs, mesh):
    """Each leaf's block under its spec, as a tensor of its own."""
    return tree_map(lambda t, s: block_of(t, s, mesh).contiguous().clone(), tree, specs)


def gather_whole(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``: an
    all-gather per cut dim over the mesh's groups."""
    out = block
    for i, e in enumerate(spec):
        if entry_axes(e):
            out = C.gather_blocks(out, e, i, mesh)
    return out
