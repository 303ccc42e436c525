"""``repro_torch.reduce.reduce`` and ``reduce_tree``: the reduction entry
points of the serving path.

Port of ``repro/reduce/api.py`` restricted to this slice:

  reduce(x, axis=-1, kind=...)   -- row reductions, kinds sum / sumsq /
                                    moments (the norm and softmax
                                    statistics), on any backend
  reduce_tree(leaves, kind=...)  -- a whole tree of arrays to one
                                    statistic (sum / sumsq / norm2), with
                                    epilogue chains, per-leaf partials and
                                    the in-launch NaN/Inf census; on
                                    cuda_fused ONE kernel launch

Full reductions (``axis=None``: the reference's kernels K1-K3) and
``reduce_many`` are not ported yet and raise NotImplementedError. Nothing
here needs a gradient: the serving path runs under inference mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import common as _kcommon
from repro_torch.reduce import backends as _backends
from repro_torch.reduce.plan import plan_for

AXIS_KINDS = ("sum", "sumsq", "moments")
TREE_KINDS = ("sum", "sumsq", "norm2")


def reduce(
    x: torch.Tensor,
    axis=-1,
    kind: str = "sum",
    *,
    backend: Optional[str] = None,
    compute_dtype=None,
):
    """Reduce ``x`` over its LAST axis: "sum" and "sumsq" -> (...) in the
    plan's accumulator dtype; "moments" -> the (sum, sumsq) pair, both from
    one stacked all-ones product. The square of "sumsq" is taken at
    accumulator precision before the row sum, as in the reference."""
    if axis is None:
        raise NotImplementedError(
            "full reductions (axis=None; the reference's fused kernels K1-K3) "
            "are not ported yet"
        )
    if kind not in AXIS_KINDS:
        raise NotImplementedError(
            f"kind {kind!r} is not ported for axis reductions; ported: {AXIS_KINDS}"
        )
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if len(axes) != 1 or axes[0] % max(x.ndim, 1) != x.ndim - 1:
        raise NotImplementedError(
            f"only the last axis is ported; got axis={axis!r} for ndim {x.ndim}"
        )
    p = plan_for(x.shape, x.dtype, kind=kind, axis=-1, backend=backend,
                 compute_dtype=compute_dtype)
    be = _backends.get_backend(p.backend)
    accum = p.accum_torch
    if x.shape[-1] == 0 or x.numel() == 0:
        z = torch.zeros(x.shape[:-1], dtype=accum, device=x.device)
        return (z, z.clone()) if kind == "moments" else z
    if kind == "sum":
        return be.sum_axis(x, p).to(accum)
    if kind == "sumsq":
        xf = x.to(accum)
        return be.sum_axis(xf * xf, p).to(accum)
    s, ss = be.moments_axis(x, p)
    return s.to(accum), ss.to(accum)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list / tuple of tensors, dict keys sorted
    (the reference's flatten order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if tree is None:
        return []
    raise TypeError(f"reduce_tree leaves must be tensors; got {type(tree).__name__}")


def reduce_tree(
    tree,
    kind: str = "sumsq",
    *,
    backend: Optional[str] = None,
    epilogue=None,
    return_per_leaf: bool = False,
    census: bool = False,
):
    """Reduce a whole tree of arrays to one statistic ("sum", "sumsq" or
    "norm2").

    ``epilogue`` finishes the statistic: one chain, or a LIST of chains (a
    fork) for several scalars from the one reduction; chains apply to the
    kind's statistic (for "norm2" the sqrt leads every chain). A fork
    returns a (K,) vector, a single chain its scalar.
    ``return_per_leaf=True`` also returns the RAW per-leaf sums (no sqrt,
    no chain), as ``(per_leaf, result)``. ``census=True`` appends the
    per-leaf NaN/Inf counts and their total, (S + 1,) f32, counted on the
    raw elements: ``(result, counts)`` or ``(per_leaf, result, counts)``.

    On cuda_fused the leaves themselves are the launch operands: ONE launch
    squares, sums, folds, finishes the chains and counts the census. The
    other backends reduce each leaf's rows, fold the partials, and apply
    the chains and the census host-side (reference semantics).
    """
    if kind not in TREE_KINDS:
        raise ValueError(f"reduce_tree supports {TREE_KINDS}; got {kind!r}")
    chains = None
    if epilogue is not None or return_per_leaf or census:
        chains = _kcommon.normalize_epilogue_fork(epilogue if epilogue is not None else ())
        if kind == "norm2":
            chains = tuple((("sqrt",),) + ch for ch in chains)
    leaves = tree_leaves(tree)
    square = kind in ("sumsq", "norm2")
    total_n = sum(int(math.prod(leaf.shape)) for leaf in leaves)
    plan = plan_for(
        (total_n,), torch.float32, kind="sumsq" if square else "sum",
        backend=backend, compute_dtype="float32",  # exactness for clipping
    )
    accum = plan.accum_torch

    def _finish(per_leaf, out, counts=None):
        if chains is not None and len(chains) == 1:
            out = out.reshape(())
        pieces = (out,)
        if return_per_leaf:
            pieces = (per_leaf,) + pieces
        if census:
            pieces = pieces + (counts,)
        return pieces[0] if len(pieces) == 1 else pieces

    if not leaves:
        zero = torch.zeros((), dtype=accum)
        if chains is None:
            return zero
        totals = torch.stack([_kcommon.apply_epilogue(zero, ch) for ch in chains])
        return _finish(torch.zeros((0,), dtype=accum), totals, torch.zeros((1,), dtype=accum))
    be = _backends.get_backend(plan.backend)
    prologue = "square" if square else "identity"
    if be.native_prologue:
        if chains is not None:
            out = be.sum_parts_total(leaves, plan, prologue, chains, census).to(accum)
            s, k = len(leaves), len(chains)
            if census:
                return _finish(out[:s], out[s:s + k], out[s + k:])
            return _finish(out[:s], out[s:])
        total = torch.sum(be.sum_parts(leaves, plan, prologue))
        return torch.sqrt(total) if kind == "norm2" else total
    partials = []
    for leaf in leaves:
        xf = leaf.to(accum)
        v = xf * xf if square else xf
        if v.ndim == 0:
            partials.append(v.reshape(1))
            continue
        partials.append(be.sum_axis(v, plan).to(accum).reshape(-1))
    per_leaf = be.sum_parts(partials, plan).to(accum)
    total = torch.sum(per_leaf)
    if chains is not None:
        totals = torch.stack([_kcommon.apply_epilogue(total, ch) for ch in chains]).to(accum)
        counts = _backends.host_nonfinite_census(leaves, accum) if census else None
        return _finish(per_leaf, totals, counts)
    return torch.sqrt(total) if kind == "norm2" else total
