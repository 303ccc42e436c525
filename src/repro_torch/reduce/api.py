"""``repro_torch.reduce.reduce``, ``reduce_many`` and ``reduce_tree``: the
reduction entry points.

Port of ``repro/reduce/api.py``:

  reduce(x)                      -- full reductions (axis=None, the
                                    default, as in the reference), kinds
                                    sum / mean / sumsq / norm2 / moments,
                                    with the in-kernel prologue, an
                                    epilogue chain, ``census=True`` and
                                    ``precision="kahan"``; on cuda_fused
                                    ONE launch (K1, the moments pair K2,
                                    the Kahan carry K3), on cuda_hier one
                                    launch per level of eq. 13 (K10)
  reduce(x, axis=..., kind=...)  -- reductions over axes, kinds sum / mean
                                    / sumsq / norm2 / moments (the norm and
                                    softmax statistics), on any backend
  reduce_many(arrays, kind=...)  -- N arrays reduced in ONE backend pass:
                                    each fully (axis=None) -> (N,), or over
                                    its last axis (axis=-1) -> a list; on
                                    the kernel backends one launch of the
                                    parts kernel (K4) up to 128 live
                                    arrays, past that the arrays packed and
                                    one launch of the gather kernel (K8)
  reduce_tree(leaves, kind=...)  -- a whole tree of arrays to one
                                    statistic (sum / sumsq / norm2), with
                                    epilogue chains, per-leaf partials and
                                    the in-launch NaN/Inf census; on
                                    cuda_fused ONE launch of the parts
                                    kernel (K4)

``precision="kahan"`` compensates the full sum: inside the fused kernel's
one launch on cuda_fused (``native_kahan``), elsewhere by the blocked
combine ``_kahan_sum_all`` (each block of ``kahan_block`` elements summed
by the backend, a serial Kahan pass over the block totals). Row
reductions have no serial combine to compensate and multiply at the
accumulator width instead (``_row_plan``).

Differentiation: the torch and mma_torch backends are torch code and
differentiate natively. A kernel-backed full reduction goes through
``_KSum``, the counterpart of the reference's custom-VJP ``_ksum``: the
cotangent is the prologue's chain rule (identity: broadcast g; square:
2 x g; abs: sign(x) g), after the epilogue's own chain rule taken by
autograd on the raw total; full moments through ``_KMoments`` (the
reference's ``_kmoments``: gs + 2 x gss). The parts pass of ``reduce_many``
and ``reduce_tree`` goes through ``_KSumParts`` and ``_KSumPartsTotal``
(the reference's ``_ksum_parts`` and ``_ksum_parts_total``): each part's
cotangent is the prologue's chain rule against its slot(s), after the
chains' own rule at the raw totals. Not differentiable: ``reduce(...,
census=True)`` (raises on an input that requires grad).

``mesh_axes=`` (names of axes of the mesh bound by
``core.collectives.bound_mesh``; full reductions only) makes a statistic
global across ranks: the local launch computes the shard's ADDITIVE row
exactly as a single rank would (on the kernel backends ``reduce_tree``'s
row ``[per leaf | raw total | census counts]`` from ONE K4 launch), one
fixed-order combine (``Backend.cross_device_combine``) folds the ranks'
rows in rank order, and the finishers (norm2's sqrt, mean's 1/n over the
global count, the chains) apply to the combined row. Every output is then
bitwise the same on every rank. Not differentiable: it raises on an input
that requires grad.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import precision as _precision
from repro_torch.kernels import common as _kcommon
from repro_torch.reduce import backends as _backends
from repro_torch.reduce import plan as P
from repro_torch.reduce.plan import ReducePlan, dtype_name, norm_mesh_axes, plan_for

# what ``reduce``'s ``axis`` takes: None (every axis), one axis, or several
Axis = Union[None, int, Sequence[int]]

KINDS = ("sum", "mean", "sumsq", "norm2", "moments")
TREE_KINDS = ("sum", "sumsq", "norm2")

# sentinel for axis=(): numpy semantics -- reduce over NO axes (identity)
_NO_AXES = ()


def _normalize_axis(axis: Axis, ndim: int):
    """-> None (reduce everything), () (reduce nothing), or a sorted tuple
    of unique non-negative axes (the reference's ``_normalize_axis``)."""
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if not axes:
        return _NO_AXES
    out = []
    for a in axes:
        if ndim == 0:
            if a not in (0, -1):
                raise ValueError(f"axis {a} out of range for 0-d array")
            continue
        if not -ndim <= a < ndim:
            raise ValueError(f"axis {a} out of range for ndim {ndim}")
        a %= ndim
        if a in out:
            raise ValueError(f"duplicate axis {a} in reduction axes")
        out.append(a)
    if ndim == 0 or len(out) == ndim:
        return None  # covers every axis: a full reduction
    return tuple(sorted(out))


def _to_rows(x: torch.Tensor, axis: tuple):
    """Move the reduced axes last and flatten them: -> ((..., L), batch)."""
    keep = tuple(a for a in range(x.ndim) if a not in axis)
    xt = x.permute(keep + axis)
    batch = xt.shape[: len(keep)]
    return xt.reshape(batch + (int(math.prod(xt.shape[len(keep):])),)), batch


def _kahan_sum_all(x: torch.Tensor, plan: ReducePlan, be, prologue: str = "identity"):
    """The blocked compensated combine (the reference's ``_kahan_sum_all``):
    the backend sums each zero-padded f32 block of ``plan.kahan_block``
    elements (``block_sums``: batched, one launch per level on cuda_hier),
    then a serial Kahan pass over the block totals. Zero padding is exact:
    0 is a fixed point of every prologue."""
    flat = x.reshape(-1)
    if flat.numel() <= plan.kahan_block:
        return be.sum_all(flat.to(plan.accum_torch), plan, prologue)
    return _precision.kahan_sum(be.block_sums(flat, plan, prologue), dtype=plan.accum_torch)


def _sum_all_impl(x: torch.Tensor, plan: ReducePlan, prologue: str = "identity",
                  epilogue: tuple = ()) -> torch.Tensor:
    """The backend's full sum under the plan's precision policy."""
    be = _backends.get_backend(plan.backend)
    if plan.precision == "kahan" and not be.native_kahan:
        # the epilogue maps the compensated total: a post-combine chain
        out = _kahan_sum_all(x, plan, be, prologue).to(plan.accum_torch)
        return _kcommon.apply_epilogue(out, epilogue)
    return be.sum_all(x, plan, prologue, epilogue).to(plan.accum_torch)


class _KSum(torch.autograd.Function):
    """Kernel-backed full reduction with the reference's ``_ksum`` VJP. The
    forward reduces epilogue-free and applies the chain host-side, so the
    backward can take the chain's derivative at the raw total. It saves
    only what the backward reads -- x for square/abs, the raw total for a
    chain -- so a recompute under ``torch.utils.checkpoint`` (which stops at
    the last saved tensor) need not rerun a plain sum's kernel."""

    @staticmethod
    def forward(ctx, x, plan, prologue, epilogue):
        raw = _sum_all_impl(x, plan, prologue)
        ctx.plan, ctx.prologue, ctx.epilogue = plan, prologue, epilogue
        ctx.shape, ctx.dtype = x.shape, x.dtype
        ctx.save_for_backward(x if prologue != "identity" else None,
                              raw if epilogue else None)
        return _kcommon.apply_epilogue(raw, epilogue)

    @staticmethod
    def backward(ctx, g):
        x, raw = ctx.saved_tensors
        if ctx.epilogue:
            with torch.enable_grad():
                r = raw.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(_kcommon.apply_epilogue(r, ctx.epilogue), r,
                                           g.to(raw.dtype))
        if ctx.prologue == "identity":
            return g.expand(ctx.shape).to(ctx.dtype), None, None, None
        xf = x.to(ctx.plan.accum_torch)
        dx = 2.0 * xf * g if ctx.prologue == "square" else torch.sign(xf) * g
        return dx.to(ctx.dtype), None, None, None


def _sum_full(x: torch.Tensor, plan: ReducePlan, prologue: str = "identity",
              epilogue: tuple = ()) -> torch.Tensor:
    """Differentiable full sum dispatch: native autograd on the torch-code
    backends, ``_KSum`` around the kernel and around the Kahan pass (a
    host loop over the block totals)."""
    accum = plan.accum_torch
    if x.numel() == 0:
        return _kcommon.apply_epilogue(torch.zeros((), dtype=accum, device=x.device), epilogue)
    be = _backends.get_backend(plan.backend)
    if (not be.native_autodiff or plan.precision == "kahan") and _kcommon.needs_grad(x):
        return _KSum.apply(x, plan, prologue, epilogue)
    return _sum_all_impl(x, plan, prologue, epilogue)


class _KMoments(torch.autograd.Function):
    """Kernel-backed full (sum, sumsq) with the reference's ``_kmoments``
    VJP: dx = gs + 2 x gss."""

    @staticmethod
    def forward(ctx, x, plan):
        s, ss = _backends.get_backend(plan.backend).moments_all(x, plan)
        ctx.plan = plan
        ctx.save_for_backward(x)
        return s.to(plan.accum_torch), ss.to(plan.accum_torch)

    @staticmethod
    def backward(ctx, gs, gss):
        (x,) = ctx.saved_tensors
        xf = x.to(ctx.plan.accum_torch)
        return (gs + 2.0 * xf * gss).to(x.dtype), None


def _moments_full(x: torch.Tensor, plan: ReducePlan):
    """Differentiable full (sum, sumsq): under ``precision="kahan"`` two
    compensated sums (identity, square); else the backend's one pass."""
    accum = plan.accum_torch
    if x.numel() == 0:
        z = torch.zeros((), dtype=accum, device=x.device)
        return z, z.clone()
    if plan.precision == "kahan":
        return _sum_full(x, plan), _sum_full(x, plan, "square")
    be = _backends.get_backend(plan.backend)
    if not be.native_autodiff and _kcommon.needs_grad(x):
        return _KMoments.apply(x, plan)
    s, ss = be.moments_all(x, plan)
    return s.to(accum), ss.to(accum)


def _row_plan(plan: ReducePlan) -> ReducePlan:
    """Row reductions have no serial combine to compensate: under
    ``precision="kahan"`` they multiply at the accumulator width."""
    if plan.precision == "kahan":
        return plan.replace(compute_dtype=plan.accum_dtype)
    return plan


def _cross_combine(row: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
    """Fold per-rank ADDITIVE partials across ``plan.mesh_axes``."""
    return _backends.get_backend(plan.backend).cross_device_combine(row, plan)


def _refuse_mesh_grad(*tensors) -> None:
    if _kcommon.needs_grad(*tensors):
        raise RuntimeError("mesh_axes= is not differentiable (the gather has no backward "
                           "here); call it under torch.no_grad()")


def _mesh_count(n: int, plan: ReducePlan) -> int:
    """The global element count of equal shards of n elements."""
    from repro_torch.core import collectives as _coll  # deferred: import cycle

    return n * _coll.mesh_world_size(plan.mesh_axes)


def _reduce_mesh_full(x: torch.Tensor, kind: str, p: ReducePlan, chain: tuple):
    """Full reduction with ``p.mesh_axes`` bound: the shard's additive
    statistic from the local launch, one fixed-order combine, then the
    kind's finisher and the chain on the combined total (they are not
    additive, so they cannot run before the fold)."""
    _refuse_mesh_grad(x)
    lp = p.replace(mesh_axes=())
    if kind == "moments":
        s, ss = _moments_full(x, lp)
        row = _cross_combine(torch.stack([s, ss]), p)
        return row[0], row[1]
    local = _sum_full(x, lp, "square" if kind in ("sumsq", "norm2") else "identity")
    total = _cross_combine(local, p)
    if kind == "mean":
        count = _mesh_count(x.numel(), p)
        total = total * ((1.0 / count) if count else float("nan"))
    if kind == "norm2":
        total = torch.sqrt(total)
    return _kcommon.apply_epilogue(total, chain)


def _reduce_census_full(x: torch.Tensor, kind: str, plan: ReducePlan, chain: tuple):
    """Full reduction plus the NaN/Inf count of x from the same launch:
    ``(statistic, count)``. The kind's finisher (norm2's sqrt, mean's 1/n)
    leads the chain. Under ``plan.mesh_axes`` the additive row (sum, raw
    total, counts) of one parts launch rides the fixed-order combine and
    the finishers apply to the combined total."""
    if _kcommon.needs_grad(x):
        raise RuntimeError("census=True is not differentiable; call it under torch.no_grad()")
    if plan.precision == "kahan":
        # the census rides the one uncompensated pass (the reference's parts
        # path), multiplying at the accumulator width
        plan = plan.replace(precision="native", compute_dtype=plan.accum_dtype)
    accum = plan.accum_torch
    prologue = "square" if kind in ("sumsq", "norm2") else "identity"
    post = chain
    if kind == "norm2":
        post = (("sqrt",),) + post
    if kind == "mean":
        n = _mesh_count(x.numel(), plan) if plan.mesh_axes else x.numel()
        post = (("scale", 1.0 / n if n else float("nan")),) + post
    if x.numel() == 0:
        z = torch.zeros((), dtype=accum, device=x.device)
        return _kcommon.apply_epilogue(z, post), z
    if plan.mesh_axes:
        # row: [per-part sum | raw total | counts (part 0, total)]
        row = _sum_parts_total_impl([x], plan.replace(mesh_axes=()), prologue, ((),), True)
        row = _cross_combine(row, plan)
        return _kcommon.apply_epilogue(row[1], post).to(accum), row[3]
    stat, count = _backends.get_backend(plan.backend).sum_all(x, plan, prologue, post,
                                                              census=True)
    return stat.to(accum), count.to(accum)


def _resolve_plan(shape, dtype, axis_t, kind, plan, segments=None, device=None,
                  **fields) -> ReducePlan:
    """The planner's choice (``plan_for``, auto routed by the operand's
    ``device``), or the given plan with the set keyword fields overriding
    it (the reference's ``_resolve_plan``)."""
    if plan is None:
        return plan_for(shape, dtype, kind=kind, axis=axis_t or None, segments=segments,
                        device=device, **fields)
    over = {k: v for k, v in fields.items() if v is not None}
    if "mesh_axes" in over:
        over["mesh_axes"] = norm_mesh_axes(over["mesh_axes"])
    for key in ("compute_dtype", "accum_dtype"):
        if key in over:
            over[key] = dtype_name(over[key])
    return plan.replace(**over) if over else plan


def reduce(
    x: torch.Tensor,
    axis: Axis = None,
    kind: str = "sum",
    *,
    plan: Optional[ReducePlan] = None,
    backend: Optional[str] = None,
    compute_dtype=None,
    accum_dtype=None,
    num_lanes: Optional[int] = None,
    tiles_per_block: Optional[int] = None,
    precision: Optional[str] = None,
    kahan_block: Optional[int] = None,
    epilogue=None,
    census: bool = False,
    mesh_axes=None,
):
    """Reduce ``x`` over ``axis`` (None = all elements, the default; () =
    no axes, numpy's convention). The result's dtype is the plan's
    ``accum_dtype`` (f32, f64 for f64 input, unless set).

    kind: "sum"; "mean" (an empty full mean is NaN, 0/0); "sumsq" (full
    reductions square in-kernel at the plan's compute dtype on the kernel
    backends -- f32 by default for sumsq/norm2 -- and at accumulator
    precision elsewhere; axis reductions square at accumulator precision);
    "norm2" (sqrt of sumsq); "moments" ((sum, sumsq): one stacked all-ones
    product over axes; a full one in one pass -- the moments kernel K2 on
    cuda_fused, a dual level-0 launch on cuda_hier -- with squares at the
    plan's compute dtype, bf16 by default).

    ``plan`` pins the whole strategy; the keyword fields override it (or
    the planner's choice): ``compute_dtype`` and ``accum_dtype`` set the
    multipliers' and the result's dtypes, ``num_lanes`` stripes the fused kernels over
    that many CTAs (None: the device's default), ``tiles_per_block`` sets
    the kernels' block depth, ``precision="kahan"`` compensates the full
    sum (``kahan_block``: the blocked combine's block length).

    ``epilogue`` appends a scalar chain to a FULL reduction (after the
    kind's own finisher: norm2's sqrt and mean's 1/n lead it); on the
    kernel backends it runs inside the launch that forms the total.
    ``census=True`` (full reductions, not moments) also returns the
    NaN/Inf count of x's elements: ``(statistic, count)``. All kinds are
    differentiable (see the module doc) except with ``census`` or
    ``mesh_axes``.

    ``mesh_axes`` (an axis name or a tuple of names of the bound mesh; full
    reductions only) makes the statistic global across ranks through the
    fixed-order combine, bitwise the same on every rank (see the module
    doc); with ``census`` the count rides the same combine.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    chain = _kcommon.normalize_epilogue(epilogue)
    axis_t = _normalize_axis(axis, x.ndim)
    if (census or chain) and axis_t is not None:
        raise ValueError(
            "census and epilogue chains apply to FULL reductions (axis=None); "
            f"got axis={axis!r}"
        )
    if (census or chain) and kind == "moments":
        raise ValueError("census and epilogue chains do not compose with kind='moments'")
    p = _resolve_plan(x.shape, x.dtype, axis_t, kind, plan, device=x.device,
                      backend=backend, compute_dtype=compute_dtype,
                      accum_dtype=accum_dtype, num_lanes=num_lanes, tiles_per_block=tiles_per_block,
                      precision=precision, kahan_block=kahan_block, mesh_axes=mesh_axes)
    accum = p.accum_torch
    if census:
        return _reduce_census_full(x, kind, p, chain)
    if p.mesh_axes:
        if axis_t is not None:
            raise ValueError("mesh_axes= applies to FULL reductions (axis=None): the combine "
                             f"makes one global statistic; got axis={axis!r}")
        return _reduce_mesh_full(x, kind, p, chain)
    if axis_t == _NO_AXES:
        xf = x.to(accum)
        return {"sum": xf, "mean": xf, "sumsq": xf * xf, "norm2": torch.abs(xf),
                "moments": (xf, xf * xf)}[kind]
    if axis_t is None:
        if kind == "sum":
            return _sum_full(x, p, epilogue=chain)
        if kind == "mean":
            n = x.numel()
            if chain:
                inv = 1.0 / n if n else float("nan")
                return _sum_full(x, p, epilogue=(("scale", inv),) + chain)
            return _sum_full(x, p) / n
        if kind == "sumsq":
            return _sum_full(x, p, "square", chain)
        if kind == "norm2":
            if chain:
                return _sum_full(x, p, "square", (("sqrt",),) + chain)
            return torch.sqrt(_sum_full(x, p, "square"))
        return _moments_full(x, p)
    rows, batch = _to_rows(x, axis_t)
    be = _backends.get_backend(p.backend)
    rp = _row_plan(p)
    if rows.shape[-1] == 0 or rows.numel() == 0:
        z = torch.zeros(batch, dtype=accum, device=x.device)
        if kind == "moments":
            return z, z.clone()
        return z / 0 if kind == "mean" else z
    if kind == "moments":
        s, ss = be.moments_axis(rows, rp)
        return s.to(accum), ss.to(accum)
    if kind in ("sum", "mean"):
        out = be.sum_axis(rows, rp).to(accum)
        return out / rows.shape[-1] if kind == "mean" else out
    xf = rows.to(accum)
    out = be.sum_axis(xf * xf, rp).to(accum)
    return torch.sqrt(out) if kind == "norm2" else out


# ------------------------- the parts pass (K4, K8) ---------------------------


def _sum_parts_impl(parts, plan: ReducePlan, prologue="identity", epilogue: tuple = ()):
    """(S,) (or (2 S,) with moments) per-part sums of the backend's pass."""
    accum = plan.accum_torch
    if not parts:
        return torch.zeros((0,), dtype=accum)
    if plan.precision == "kahan":
        # each part flushes once: no serial combine to compensate, so the
        # multipliers run at the accumulator width, as for rows
        plan = plan.replace(compute_dtype=plan.accum_dtype)
    return _backends.get_backend(plan.backend).sum_parts(tuple(parts), plan, prologue,
                                                         epilogue).to(accum)


def _sum_parts_total_impl(parts, plan: ReducePlan, prologue="identity", chains=((),),
                          census: bool = False):
    """(S + K [+ S + 1],): per-part sums, chain k of their total at S + k,
    and the census counts, from one backend pass."""
    if plan.precision == "kahan":
        plan = plan.replace(compute_dtype=plan.accum_dtype)
    return _backends.get_backend(plan.backend).sum_parts_total(
        tuple(parts), plan, prologue, chains, census).to(plan.accum_torch)


def _parts_grads(ctx, g):
    """Per-part cotangents from the (S,) or (2 S,) slot cotangent ``g``:
    identity broadcasts g[s]; square 2 x g[s]; abs sign(x) g[s]; moments
    g[s] + 2 x g[S + s]."""
    saved = ctx.saved_tensors
    nseg = len(ctx.pros)
    grads = []
    for s, (pro, x, shape, dtype) in enumerate(zip(ctx.pros, saved, ctx.shapes, ctx.dtypes)):
        if not ctx.needs_input_grad[ctx.first + s]:
            grads.append(None)
            continue
        if pro == "identity":
            grads.append(g[s].expand(shape).to(dtype))
            continue
        xf = x.to(ctx.accum)
        if pro == "square":
            dx = 2.0 * xf * g[s]
        elif pro == "abs":
            dx = torch.sign(xf) * g[s]
        else:
            dx = g[s] + 2.0 * xf * g[nseg + s]
        grads.append(dx.to(dtype))
    return grads


def _save_parts(ctx, parts, prologue, plan, first):
    """Keep what the chain rule reads: the parts of non-identity prologues,
    and every part's shape and dtype."""
    ctx.pros = _kcommon.normalize_part_prologues(prologue, len(parts))
    ctx.shapes = [p.shape for p in parts]
    ctx.dtypes = [p.dtype for p in parts]
    ctx.accum = plan.accum_torch
    ctx.first = first
    ctx.save_for_backward(*[p if pro != "identity" else None
                            for p, pro in zip(parts, ctx.pros)])


def _chain_grad(raw: torch.Tensor, chain: tuple, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``apply_epilogue(raw, chain)`` mapped back to raw."""
    with torch.enable_grad():
        r = raw.detach().requires_grad_(True)
        (out,) = torch.autograd.grad(_kcommon.apply_epilogue(r, chain), r, g.to(raw.dtype))
    return out


class _KSumParts(torch.autograd.Function):
    """The kernel-backed parts pass with the reference's ``_ksum_parts``
    VJP. The forward sums epilogue-free and maps the chain host-side, so
    the backward can take the chain's derivative at the raw sums."""

    @staticmethod
    def forward(ctx, plan, prologue, epilogue, *parts):
        raw = _sum_parts_impl(parts, plan, prologue)
        _save_parts(ctx, parts, prologue, plan, 3)
        ctx.epilogue, ctx.raw = epilogue, raw.detach() if epilogue else None
        return _kcommon.apply_epilogue(raw, epilogue)

    @staticmethod
    def backward(ctx, g):
        if ctx.epilogue:
            g = _chain_grad(ctx.raw, ctx.epilogue, g)
        return (None, None, None, *_parts_grads(ctx, g))


class _KSumPartsTotal(torch.autograd.Function):
    """The kernel-backed per-part sums plus the chains of their total, with
    the reference's ``_ksum_parts_total`` VJP. As the reference's
    differentiated forward, the chains (and the census, from the host)
    finish on the host, so the backward has the raw total: slot s feeds its
    own output and, through the total, every chain output."""

    @staticmethod
    def forward(ctx, plan, prologue, chains, census, *parts):
        per = _sum_parts_impl(parts, plan, prologue)
        total = torch.sum(per)
        pieces = [per, torch.stack([_kcommon.apply_epilogue(total, ch)
                                    for ch in chains]).to(per.dtype)]
        if census:
            pieces.append(_backends.host_nonfinite_census(parts, per.dtype))
        _save_parts(ctx, parts, prologue, plan, 4)
        ctx.chains, ctx.total = chains, total.detach()
        return torch.cat(pieces)

    @staticmethod
    def backward(ctx, g):
        nseg = len(ctx.pros)
        gtot = torch.zeros((), dtype=ctx.total.dtype, device=g.device)
        for k, ch in enumerate(ctx.chains):
            gtot = gtot + _chain_grad(ctx.total, ch, g[nseg + k])
        return (None, None, None, None, *_parts_grads(ctx, g[:nseg] + gtot))


def _prologue_arg(prologue):
    return prologue if isinstance(prologue, str) else tuple(prologue)


def _sum_parts(parts, plan: ReducePlan, prologue="identity", epilogue: tuple = ()):
    """Differentiable parts pass: native autograd on the torch-code
    backends, ``_KSumParts`` around the kernels."""
    parts, prologue = tuple(parts), _prologue_arg(prologue)
    if _backends.get_backend(plan.backend).native_autodiff or not _kcommon.needs_grad(*parts):
        return _sum_parts_impl(parts, plan, prologue, epilogue)
    return _KSumParts.apply(plan, prologue, epilogue, *parts)


def _sum_parts_total(parts, plan: ReducePlan, prologue="identity", chains=((),),
                     census: bool = False):
    """Differentiable per-part sums plus the chains of their total."""
    parts, prologue = tuple(parts), _prologue_arg(prologue)
    if _backends.get_backend(plan.backend).native_autodiff or not _kcommon.needs_grad(*parts):
        return _sum_parts_total_impl(parts, plan, prologue, chains, census)
    return _KSumPartsTotal.apply(plan, prologue, chains, census, *parts)


def _reduce_many_full(arrs, kind: str, plan: ReducePlan, chain: tuple = ()):
    """Every array fully reduced by one parts pass: each array its own
    operand in its own dtype on the kernel backends (squares for
    sumsq/norm2 and the moments pair in-kernel), packed at accumulator
    precision by the torch-code backends. ``chain`` maps every per-array
    statistic (sum/sumsq/norm2)."""
    sizes = [a.numel() for a in arrs]
    if kind in ("sum", "mean"):
        out = _sum_parts(arrs, plan, epilogue=chain)
        if kind == "mean":
            out = out / torch.tensor([max(n, 1) for n in sizes], dtype=plan.accum_torch,
                                     device=out.device)
        return out
    if kind == "sumsq":
        return _sum_parts(arrs, plan, "square", chain)
    if kind == "norm2":
        if chain:
            return _sum_parts(arrs, plan, "square", (("sqrt",),) + chain)
        return torch.sqrt(_sum_parts(arrs, plan, "square"))
    # moments: both statistics from the one pass, the (2N,) layout
    out = _sum_parts(arrs, plan, "moments")
    return out[:len(arrs)], out[len(arrs):]


def _reduce_many_full_mesh(arrs, kind: str, p: ReducePlan, chain: tuple):
    """``reduce_many(axis=None)`` with ``p.mesh_axes``: one local parts
    pass makes the shard's additive (N,) vector ((2N,) for moments), one
    fixed-order combine folds the ranks' vectors, and the finishers and the
    chain map the combined vector."""
    _refuse_mesh_grad(*arrs)
    lp = p.replace(mesh_axes=())
    s = len(arrs)
    if kind == "moments":
        out = _cross_combine(_sum_parts(arrs, lp, "moments"), p)
        return out[:s], out[s:]
    out = _cross_combine(
        _sum_parts(arrs, lp, "square" if kind in ("sumsq", "norm2") else "identity"), p)
    if kind == "mean":
        out = out / torch.tensor([max(_mesh_count(a.numel(), p), 1) for a in arrs],
                                 dtype=p.accum_torch, device=out.device)
    if kind == "norm2":
        out = torch.sqrt(out)
    return _kcommon.apply_epilogue(out, chain)


def _reduce_many_rows(arrs, kind: str, plan: ReducePlan):
    """Every array reduced over its last axis in one backend pass: the rows
    zero-padded to the widest (exact: zeros add nothing) and stacked into
    one row stream. Torch code on every backend, so autograd flows."""
    accum = plan.accum_torch
    for a in arrs:
        if a.ndim == 0:
            raise ValueError("reduce_many(axis=-1) needs arrays of ndim >= 1")
    batch_shapes = [tuple(a.shape[:-1]) for a in arrs]
    widths = [int(a.shape[-1]) for a in arrs]
    rows_per = [int(math.prod(b)) for b in batch_shapes]
    live = [i for i in range(len(arrs)) if widths[i] > 0 and rows_per[i] > 0]

    def identities():
        return [torch.zeros(b, dtype=accum, device=a.device) for a, b in zip(arrs, batch_shapes)]

    if not live:
        return (identities(), identities()) if kind == "moments" else identities()
    lmax = max(widths[i] for i in live)

    def stream(src):
        rows = []
        for i in live:
            r = src[i].to(accum).reshape(-1, widths[i])
            if widths[i] < lmax:
                r = torch.nn.functional.pad(r, (0, lmax - widths[i]))
            rows.append(r)
        return rows[0] if len(rows) == 1 else torch.cat(rows)

    def split(flat_out):
        outs = identities()
        for i, piece in zip(live, torch.split(flat_out, [rows_per[i] for i in live])):
            outs[i] = piece.reshape(batch_shapes[i])
        return outs

    rp = _row_plan(plan)
    be = _backends.get_backend(rp.backend)
    if kind == "moments":
        s, ss = be.moments_axis(stream(arrs), rp)
        return split(s.to(accum)), split(ss.to(accum))
    src = [torch.square(a.to(accum)) for a in arrs] if kind in ("sumsq", "norm2") else list(arrs)
    outs = split(be.sum_axis(stream(src), rp).to(accum))
    if kind == "mean":
        return [o / max(w, 1) for o, w in zip(outs, widths)]
    if kind == "norm2":
        return [torch.sqrt(o) for o in outs]
    return outs


def reduce_many(
    arrays,
    kind: str = "sum",
    *,
    axis: Optional[int] = None,
    plan: Optional[ReducePlan] = None,
    backend: Optional[str] = None,
    compute_dtype=None,
    accum_dtype=None,
    num_lanes: Optional[int] = None,
    tiles_per_block: Optional[int] = None,
    precision: Optional[str] = None,
    kahan_block: Optional[int] = None,
    epilogue=None,
    mesh_axes=None,
):
    """Reduce N independent arrays in ONE backend pass instead of N.

    ``arrays`` is a tree of tensors (``tree_leaves`` order). ``axis=None``
    reduces every array fully -> an (N,) vector (moments: a pair of (N,)
    vectors, both from the same pass as 2N slots); ``axis=-1`` reduces each
    over its own last axis (widths may differ) -> a list (moments: a pair
    of lists). Kinds as ``reduce``; an empty array's mean is 0 (0 / 1).

    On the kernel backends the full reduction is ONE launch of the parts
    kernel (K4), each array its own operand, mapped in-kernel at the
    plan's compute dtype (bf16 for sum/mean/moments, f32 for sumsq/norm2,
    as ``plan_for`` chooses); past 128 live arrays the arrays are packed at
    accumulator precision and summed by ONE launch of the gather kernel
    (K8), the reference's route. The auto backend is the "segmented" route.
    ``epilogue`` (axis=None; sum/sumsq/norm2) maps every per-array
    statistic. Differentiable on every backend. ``mesh_axes`` (axis=None
    only) makes every per-array statistic global across ranks: the whole
    vector rides ONE fixed-order combine (see ``reduce``).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    if axis not in (None, -1):
        raise ValueError("reduce_many reduces each array fully (axis=None) or over its last "
                         f"axis (axis=-1); got axis={axis!r}")
    chain = _kcommon.normalize_epilogue(epilogue)
    if chain and axis is not None:
        raise ValueError(f"reduce_many epilogues apply to full reductions (axis=None); "
                         f"got axis={axis!r}")
    if chain and kind in ("mean", "moments"):
        raise ValueError(f"reduce_many epilogues do not compose with kind={kind!r} (mean: "
                         "per-array 1/n scales differ; moments: two coupled outputs)")
    arrs = tree_leaves(arrays)
    if not arrs:
        accum = P._DTYPES[dtype_name(accum_dtype)] if accum_dtype is not None else torch.float32
        z = torch.zeros((0,), dtype=accum)
        if axis is None:
            return (z, z.clone()) if kind == "moments" else z
        return ([], []) if kind == "moments" else []
    total = sum(a.numel() for a in arrs)
    dtype = functools.reduce(torch.promote_types, (a.dtype for a in arrs), arrs[0].dtype)
    p = _resolve_plan((total,), dtype, None if axis is None else (-1,), kind, plan,
                      segments=len(arrs), device=arrs[0].device, backend=backend,
                      compute_dtype=compute_dtype,
                      accum_dtype=accum_dtype, num_lanes=num_lanes,
                      tiles_per_block=tiles_per_block, precision=precision,
                      kahan_block=kahan_block, mesh_axes=mesh_axes)
    if p.mesh_axes:
        if axis is not None:
            raise ValueError("mesh_axes= applies to FULL per-array reductions (axis=None); got "
                             f"axis={axis!r}")
        return _reduce_many_full_mesh(arrs, kind, p, chain)
    if axis is None:
        return _reduce_many_full(arrs, kind, p, chain)
    return _reduce_many_rows(arrs, kind, p)



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


def _leaf_row_partials(leaves, plan: ReducePlan, be, square: bool) -> list:
    """Each leaf's last-axis sums (of squares) at accumulator precision,
    flattened: the operands of the non-kernel backends' parts pass."""
    partials = []
    for leaf in leaves:
        xf = leaf.to(plan.accum_torch)
        v = xf * xf if square else xf
        partials.append(v.reshape(1) if v.ndim == 0 else
                        be.sum_axis(v, plan).to(plan.accum_torch).reshape(-1))
    return partials


def reduce_tree(
    tree,
    kind: str = "sumsq",
    *,
    plan: Optional[ReducePlan] = None,
    backend: Optional[str] = None,
    num_lanes: Optional[int] = None,
    epilogue=None,
    return_per_leaf: bool = False,
    census: bool = False,
    mesh_axes=None,
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

    ``plan`` pins the strategy (``backend`` and ``num_lanes`` override its
    fields; the lane count reaches the kernels that take one: the gather
    kernel K8 past 128 leaves, and the fused kernels); without one the planner
    chooses for the total element count at f32 multipliers (exactness for
    clipping), on the leaves' device.

    On cuda_fused the leaves themselves are the launch operands: ONE launch
    squares, sums, folds, finishes the chains and counts the census. The
    other backends reduce each leaf's rows, fold the partials, and apply
    the chains and the census host-side (reference semantics). Leaves that
    require grad differentiate on every backend (``_KSumParts`` /
    ``_KSumPartsTotal`` around the kernel; the census counts get none).

    ``mesh_axes`` (axis names of the bound mesh) makes the whole statistic
    global across ranks: each rank's local pass over its shards (one K4
    launch on cuda_fused, the census counted in it) makes the additive row
    ``[per leaf | raw total | counts]``, ONE fixed-order combine folds the
    ranks' rows, and the chains (norm2's sqrt first) finish the combined
    total. Statistic, per-leaf sums, chain outputs and counts are bitwise
    the same on every rank.
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
    if plan is None:
        plan = plan_for(
            (total_n,), torch.float32, kind="sumsq" if square else "sum",
            backend=backend, num_lanes=num_lanes,
            compute_dtype="float32",  # exactness for clipping
            device=leaves[0].device if leaves else None, mesh_axes=mesh_axes,
        )
    else:
        over = {k: v for k, v in (("backend", backend), ("num_lanes", num_lanes),
                                  ("mesh_axes", mesh_axes)) if v is not None}
        if "mesh_axes" in over:
            over["mesh_axes"] = norm_mesh_axes(over["mesh_axes"])
        plan = plan.replace(**over) if over else plan
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
    if plan.mesh_axes:
        _refuse_mesh_grad(*leaves)
        lp = plan.replace(mesh_axes=())
        s = len(leaves)
        if be.native_prologue:
            # one launch: the identity total chain makes the row exactly
            # [per leaf | raw total | counts]
            row = _sum_parts_total(leaves, lp, prologue, ((),), census)
        else:
            per = _sum_parts(_leaf_row_partials(leaves, lp, be, square), lp)
            pieces = [per, torch.sum(per)[None]]
            if census:
                pieces.append(_backends.host_nonfinite_census(leaves, accum))
            row = torch.cat(pieces)
        row = _cross_combine(row, plan)
        total = row[s]
        if chains is None:
            return torch.sqrt(total) if kind == "norm2" else total
        totals = torch.stack([_kcommon.apply_epilogue(total, ch) for ch in chains]).to(accum)
        return _finish(row[:s], totals, row[s + 1:] if census else None)
    if be.native_prologue:
        if chains is not None:
            out = _sum_parts_total(leaves, plan, prologue, chains, census)
            s, k = len(leaves), len(chains)
            if census:
                return _finish(out[:s], out[s:s + k], out[s + k:])
            return _finish(out[:s], out[s:])
        total = torch.sum(_sum_parts(leaves, plan, prologue))
        return torch.sqrt(total) if kind == "norm2" else total
    per_leaf = _sum_parts(_leaf_row_partials(leaves, plan, be, square), plan)
    total = torch.sum(per_leaf)
    if chains is not None:
        totals = torch.stack([_kcommon.apply_epilogue(total, ch) for ch in chains]).to(accum)
        counts = _backends.host_nonfinite_census(leaves, accum) if census else None
        return _finish(per_leaf, totals, counts)
    return torch.sqrt(total) if kind == "norm2" else total
