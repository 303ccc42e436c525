"""Backend registry: the interchangeable executors behind ``repro_torch.reduce``.

Port of ``repro/reduce/backends.py``. A backend supplies these
primitives:

  sum_all(x, plan, prologue, epilogue, census)
                          -- the full reduction: the chain of the sum of
                             the prologue-mapped elements, and with
                             ``census`` also the NaN/Inf count
  sum_axis(x, plan)       -- (..., L) -> (...) sum over the last axis
  moments_axis(x, plan)   -- (..., L) -> ((...), (...)) fused (sum, sumsq)
  moments_all(x, plan)    -- the full (sum, sumsq) pair: two sums by
                             default, one pass on the kernel backends
  block_sums(flat, plan, prologue)
                          -- (nblk,) sums of the f32 blocks of
                             ``plan.kahan_block`` elements: the inner sums
                             of the blocked compensated combine
  sum_segments(flat, offsets, plan, prologue, epilogue)
                          -- S segments of one packed 1-D stream -> (S,)
                             prologue-mapped sums ("moments": (2 S,), sums
                             then sums of squares), each mapped by the chain
  sum_parts(parts, plan, prologue, epilogue)
                          -- S separate arrays -> (S,) prologue-mapped sums
                             ((2 S,) with a "moments" part); by default the
                             parts are mapped at accumulator precision,
                             packed, and summed by ONE sum_segments pass
  sum_parts_total(parts, plan, prologue, total_chains, census)
                          -- (S,) sums, then chain k of the cross-part total
                             at slot S + k, then (census) S + 1 non-finite
                             counts: the row behind ``reduce_tree``
  scan_axis(x, plan, inclusive, trace)
                          -- (..., L) -> (..., L) prefix sum over the last
                             axis (``plan`` a ``ScanPlan``), in x's dtype
  cross_device_combine(partials, plan)
                          -- per-rank additive partials combined across
                             ``plan.mesh_axes`` by the fixed-order fold

Registered here (analogues of the reference's xla / mma_jnp /
pallas_hier / pallas_fused / segmented):

  torch       -- plain ``torch.sum`` at accumulator precision; the oracle.
                 Segments by one ``index_add_`` in f64, rounded once (exact);
                 scans by ``torch.cumsum``.
  mma_torch   -- the paper's algorithm as all-ones matmuls
                 (``core.mma_reduce``): full reductions by the eq. 13
                 hierarchy, rows via one ones-product, segments as rows of
                 m through one ones-product plus an exact f32 fold of the
                 row partials; scans by the batched triangular product
                 (``kernels.scan.mma_scan_torch``).
  cuda_fused  -- the kernels: a full reduction is ONE launch of the fused
                 kernel (``kernels.mma_reduce.mma_sum_fused``, K1) with the
                 prologue at the compute dtype, the chain and the census in
                 the launch; a tree is ONE launch of the parts kernel
                 (``mma_sum_parts``, K4), every part its own operand, mapped
                 in-kernel (``native_prologue``), at the plan's compute
                 dtype. Segments are ONE launch of the gather kernel
                 (``mma_sum_segments``, K8); past ``PARTS_KERNEL_MAX`` live
                 parts, parts are packed by the base class and summed by
                 it, as the reference's kernel backends do. A 1-D scan is
                 ONE launch of the scan kernel (``mma_scan``, K9); batched
                 scans ride mma_torch's triangular product. Rows ride the
                 same ones-product as mma_torch. ``precision="kahan"`` is
                 the compensated kernel K3 (``native_kahan``: one launch);
                 full moments the moments kernel K2 (one launch).
  cuda_hier   -- the paper's hierarchy (eq. 13) on the level kernel
                 (``mma_sum_hier``, K10): one launch per level, full moments
                 from one dual level-0 launch and a hierarchy per column,
                 the blocked compensated combine's block sums in one launch
                 per level. Rows, parts and trees as cuda_fused. It has no
                 census column: with ``census`` the count is taken on the
                 host beside the hierarchy's total.
  segmented   -- the auto route of multi-reduce problems: each call picks
                 its executor (``plan.segmented_backend_for``) and
                 delegates.

``torch`` and ``mma_torch`` are torch code and differentiate natively
(``native_autodiff``); the kernel backends' full reductions differentiate
through ``reduce.api``'s ``_KSum`` and ``_KMoments`` Functions.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch

from repro_torch.core import mma_reduce as _core
from repro_torch.kernels import common as _kcommon
from repro_torch.kernels import scan as _scan_ops
from repro_torch.kernels.mma_reduce import ops as _mma_ops
from repro_torch.reduce.plan import ReducePlan, segmented_backend_for


def _host_prologue(x: torch.Tensor, plan: ReducePlan, prologue: str) -> torch.Tensor:
    """The elementwise map at accumulator precision (reference semantics of
    the non-kernel backends)."""
    return _kcommon.apply_prologue(x.to(plan.accum_torch), prologue)


def host_nonfinite_census(parts, dtype) -> torch.Tensor:
    """``out[s]`` counts the NaN/Inf elements of part s, ``out[S]`` their
    total. Integer and bool parts count 0."""
    counts = []
    for p in parts:
        if p.numel() and (p.is_floating_point() or p.is_complex()):
            counts.append(torch.sum(~torch.isfinite(p.reshape(-1))).to(dtype))
        else:
            counts.append(torch.zeros((), dtype=dtype, device=p.device))
    dev = parts[0].device if parts else None
    per = torch.stack(counts) if counts else torch.zeros((0,), dtype=dtype, device=dev)
    return torch.cat([per, torch.sum(per)[None]])


def _f32_blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    """(nblk, block) f32 view of the zero-padded flat stream."""
    n = flat.numel()
    nblk = -(-n // block)
    return torch.nn.functional.pad(flat.reshape(-1).to(torch.float32),
                                   (0, nblk * block - n)).view(nblk, block)


class Backend:
    """Base class; subclasses override the primitives."""

    name: str = "?"
    # True -> the primitives are torch code; autograd flows through them.
    native_autodiff: bool = True
    # True -> the prologue runs INSIDE the kernel on the raw leaf, and
    # reduce_tree hands the leaves themselves to sum_parts[_total].
    native_prologue: bool = False
    # True -> sum_all honours plan.precision == "kahan" itself (the fused
    # kernel's in-kernel carry); else reduce.api wraps the backend in the
    # blocked compensated combine.
    native_kahan: bool = False

    def _full_sum(self, x: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
        raise NotImplementedError

    def sum_all(self, x: torch.Tensor, plan: ReducePlan, prologue: str = "identity",
                epilogue: tuple = (), census: bool = False):
        """The chain of the sum of all prologue-mapped elements (mapped at
        accumulator precision, reference semantics of the non-kernel
        backends); ``census`` adds the NaN/Inf count of the raw elements:
        ``(total, count)``."""
        total = _kcommon.apply_epilogue(
            self._full_sum(_host_prologue(x.reshape(-1), plan, prologue), plan), epilogue)
        if census:
            return total, host_nonfinite_census([x], total.dtype)[-1]
        return total

    def sum_axis(self, x: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
        raise NotImplementedError

    def moments_all(self, x: torch.Tensor, plan: ReducePlan):
        """The full (sum, sumsq) pair: two ``sum_all`` passes, identity and
        square (the reference's default)."""
        return self.sum_all(x, plan), self.sum_all(x, plan, "square")

    def block_sums(self, flat: torch.Tensor, plan: ReducePlan,
                   prologue: str = "identity") -> torch.Tensor:
        """(nblk,) sums of the zero-padded f32 blocks of ``plan.kahan_block``
        elements of ``flat``, each what this backend's ``sum_all`` gives for
        the block, all blocks batched."""
        raise NotImplementedError

    def moments_axis(self, x: torch.Tensor, plan: ReducePlan):
        """Fused (sum, sumsq) over the last axis: the stacked all-ones
        product (both moments in one matmul)."""
        return _core.row_moments_mma(
            x.to(plan.accum_torch), compute_dtype=plan.compute_torch,
            accum_dtype=plan.accum_torch,
        )

    def sum_segments(self, flat: torch.Tensor, offsets: Sequence[int], plan: ReducePlan,
                     prologue: str = "identity", epilogue: tuple = ()) -> torch.Tensor:
        """``out[s] = sum(P(flat[offsets[s]:offsets[s + 1]]))`` ("moments":
        the (2 S,) sums then sums of squares), each sum mapped by the chain
        (not with "moments"). Default: one ``sum_all`` per segment; the
        registered backends take one pass."""
        if prologue == "moments":
            if epilogue:
                raise ValueError("segment epilogues do not compose with prologue='moments'")
            return torch.cat([self.sum_segments(flat, offsets, plan),
                              self.sum_segments(flat, offsets, plan, "square")])
        accum = plan.accum_torch
        outs = []
        for lo, hi in zip(offsets[:-1], offsets[1:]):
            if hi <= lo:
                outs.append(torch.zeros((), dtype=accum, device=flat.device))
            else:
                outs.append(self.sum_all(flat[lo:hi], plan, prologue).to(accum))
        if not outs:
            return torch.zeros((0,), dtype=accum, device=flat.device)
        return _kcommon.apply_epilogue(torch.stack(outs), epilogue)

    def sum_parts(self, parts: Sequence[torch.Tensor], plan: ReducePlan,
                  prologue="identity", epilogue: tuple = ()) -> torch.Tensor:
        """``out[s] = sum(P_s(parts[s]))`` over separate arrays (a "moments"
        part widens the result to (2 S,), its sum of squares at slot S +
        s), each sum mapped by the chain (not with "moments"). Default (the
        reference's): every part mapped at accumulator precision, the parts
        packed into one stream, and ONE ``sum_segments`` pass; empty parts
        give 0."""
        accum = plan.accum_torch
        nseg = len(parts)
        pros = _kcommon.normalize_part_prologues(prologue, nseg)
        if epilogue and "moments" in pros:
            raise ValueError("parts epilogues do not compose with a 'moments' part")
        if nseg == 0:
            return torch.zeros((0,), dtype=accum)
        dev = parts[0].device
        mapped = []
        for p, pro in zip(parts, pros):  # thousands of parts: no op on what needs none
            f = p if p.ndim == 1 else p.reshape(-1)
            if pro in ("identity", "moments"):
                mapped.append(f if f.dtype == accum else f.to(accum))
            else:
                mapped.append(_host_prologue(f, plan, pro))
        if "moments" in pros:
            # widened layout: slot S + s sums the squares of a moments part
            # (the other parts' square slots stay 0)
            mapped += [_host_prologue(p.reshape(-1), plan, "square") if pro == "moments"
                       else torch.zeros((0,), dtype=accum, device=dev)
                       for p, pro in zip(parts, pros)]
        sizes = [f.numel() for f in mapped]
        if sum(sizes) == 0:
            return _kcommon.apply_epilogue(torch.zeros((len(mapped),), dtype=accum, device=dev),
                                           epilogue)
        offsets = [0]
        for size in sizes:
            offsets.append(offsets[-1] + size)
        live = [f for f in mapped if f.numel()]
        flat = live[0] if len(live) == 1 else torch.cat(live)
        return _kcommon.apply_epilogue(self.sum_segments(flat, tuple(offsets), plan), epilogue)

    def scan_axis(self, x: torch.Tensor, plan, inclusive: bool = True,
                  trace=None) -> torch.Tensor:
        """(..., L) prefix sum over the last axis in x's dtype (``plan`` a
        ``ScanPlan``): ``torch.cumsum`` at the accumulator dtype (integers
        and bools in x's own dtype, exactly), the exclusive form as the
        inclusive one shifted -- never ``cumsum - x``."""
        acc = plan.accum_torch if x.is_floating_point() else (
            torch.int64 if x.dtype == torch.bool else x.dtype)
        out = torch.cumsum(x.to(acc), dim=-1, dtype=acc)
        if not inclusive:
            out = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]], dim=-1)
        return out.to(x.dtype)

    def sum_parts_total(self, parts, plan: ReducePlan, prologue="identity",
                        total_chains: tuple = ((),), census: bool = False):
        """Per-part sums, chain k of their total at slot S + k and, with
        ``census``, S + 1 non-finite counts -- host-side fold (reference
        semantics); cuda_fused finishes all of it in its launch."""
        if "moments" in _kcommon.normalize_part_prologues(prologue, len(parts)):
            raise ValueError("sum_parts_total does not compose with a 'moments' part")
        per = self.sum_parts(parts, plan, prologue)
        total = torch.sum(per)
        totals = torch.stack([_kcommon.apply_epilogue(total, ch) for ch in total_chains])
        pieces = [per, totals.to(per.dtype)]
        if census:
            pieces.append(host_nonfinite_census(parts, per.dtype))
        return torch.cat(pieces)


    def cross_device_combine(self, partials: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
        """Combine per-rank ADDITIVE partials across ``plan.mesh_axes``: the
        fixed-order all-gather fold (``core.collectives.fixed_order_combine``),
        never an all-reduce whose order is the transport's, so the result is
        bitwise the same on every rank at any rank count."""
        if not plan.mesh_axes:
            return partials
        from repro_torch.core import collectives as _coll  # deferred: import cycle

        return _coll.fixed_order_combine(partials, plan.mesh_axes)


class TorchBackend(Backend):
    """Plain torch reductions at accumulator precision -- the oracle."""

    name = "torch"

    def _full_sum(self, x, plan):
        return torch.sum(x)

    def sum_axis(self, x, plan):
        return torch.sum(x.to(plan.accum_torch), dim=-1)

    def moments_axis(self, x, plan):
        xf = x.to(plan.accum_torch)
        return torch.sum(xf, dim=-1), torch.sum(xf * xf, dim=-1)

    def sum_segments(self, flat, offsets, plan, prologue="identity", epilogue=()):
        # one segment sum of the whole mapped stream (the reference's
        # segment_sum), exact: float values are summed in f64 and rounded
        # once to the accumulator dtype, so the order of index_add_'s adds
        # (atomic on the card) cannot show; "moments" through the base
        # class's two passes
        if prologue == "moments":
            return super().sum_segments(flat, offsets, plan, prologue, epilogue)
        accum = plan.accum_torch
        wide = torch.float64 if accum.is_floating_point else accum
        sizes = torch.tensor([b - a for a, b in zip(offsets[:-1], offsets[1:])],
                             device=flat.device)
        ids = torch.repeat_interleave(torch.arange(sizes.numel(), device=flat.device), sizes)
        vals = _host_prologue(flat[offsets[0]:offsets[-1]], plan, prologue)
        out = torch.zeros((sizes.numel(),), dtype=wide, device=flat.device).index_add_(
            0, ids, vals.to(wide))
        return _kcommon.apply_epilogue(out.to(accum), epilogue)

    def block_sums(self, flat, plan, prologue="identity"):
        # one row sum per block: each row reduced as torch.sum reduces a
        # block of its own
        blocks = _host_prologue(_f32_blocks(flat, plan.kahan_block), plan, prologue)
        return torch.sum(blocks, dim=-1)


class MmaTorchBackend(Backend):
    """The paper's algorithm as all-ones matmuls (runs on any device)."""

    name = "mma_torch"

    def _full_sum(self, x, plan):
        return _core.mma_sum(x, m=plan.m, compute_dtype=plan.compute_torch,
                             accum_dtype=plan.accum_torch)

    def sum_axis(self, x, plan):
        return _core.row_sum_mma(
            x.to(plan.accum_torch), compute_dtype=plan.compute_torch,
            accum_dtype=plan.accum_torch,
        )

    def sum_segments(self, flat, offsets, plan, prologue="identity", epilogue=()):
        # every segment as zero-padded rows of m, all rows through ONE
        # ones-product, then an exact fold of the row partials per segment
        # (the upper rungs of the hierarchy: summed in f64, rounded once)
        if prologue == "moments":
            return super().sum_segments(flat, offsets, plan, prologue, epilogue)
        flat = _host_prologue(flat, plan, prologue)
        m, accum = plan.m, plan.accum_torch
        nseg = len(offsets) - 1
        rows, rcounts = [], []
        for lo, hi in zip(offsets[:-1], offsets[1:]):
            r = _kcommon.ceil_div(hi - lo, m) if hi > lo else 0
            rcounts.append(r)
            if r:
                rows.append(torch.nn.functional.pad(flat[lo:hi], (0, r * m - (hi - lo)))
                            .view(r, m))
        if not rows:
            return _kcommon.apply_epilogue(
                torch.zeros((nseg,), dtype=accum, device=flat.device), epilogue)
        partials = self.sum_axis(torch.cat(rows) if len(rows) > 1 else rows[0], plan)
        ids = torch.repeat_interleave(torch.arange(nseg, device=flat.device),
                                      torch.tensor(rcounts, device=flat.device))
        wide = torch.float64 if accum.is_floating_point else accum  # the exact fold
        out = torch.zeros((nseg,), dtype=wide, device=flat.device).index_add_(
            0, ids, partials.to(wide))
        return _kcommon.apply_epilogue(out.to(accum), epilogue)

    def scan_axis(self, x, plan, inclusive=True, trace=None):
        # the triangular encoding as one batched strip @ U product plus an
        # exact f32 strip carry
        return _scan_ops.mma_scan_torch(x, inclusive=inclusive, m=plan.m,
                                        compute_dtype=plan.compute_torch)

    def block_sums(self, flat, plan, prologue="identity"):
        # every block through the hierarchy on its own, all blocks in each
        # level's one batched product (the f32 products' summation order may
        # depend on the row count, so a block's bits can differ from a
        # lone mma_sum of it in the last place at f32 compute)
        blocks = _host_prologue(_f32_blocks(flat, plan.kahan_block), plan, prologue)
        out, _, _ = _core.mma_sum_rows(blocks, m=plan.m, compute_dtype=plan.compute_torch,
                                       accum_dtype=plan.accum_torch)
        return out


def _check_kernel_m(plan: ReducePlan, name: str) -> None:
    if plan.m != _mma_ops.MXU:
        raise ValueError(
            f"{name} implements the m={_mma_ops.MXU} tile only; got m={plan.m}. "
            "Use backend='mma_torch' for tile-size ablations."
        )


class CudaFusedBackend(MmaTorchBackend):
    """The one-launch fused, Kahan, moments and parts kernels; rows ride
    mma_torch's ones-product."""

    name = "cuda_fused"
    native_autodiff = False
    native_prologue = True
    native_kahan = True  # the compensation rides the one launch (K3)

    @staticmethod
    def _lanes(x, plan) -> int:
        return plan.num_lanes if plan.num_lanes is not None else _mma_ops.default_num_lanes(x)

    def sum_all(self, x, plan, prologue="identity", epilogue=(), census=False):
        _check_kernel_m(plan, self.name)
        out = _mma_ops.mma_sum_fused(
            x, compute_dtype=plan.compute_torch, prologue=prologue, epilogue=epilogue,
            census=census, num_lanes=self._lanes(x, plan), tiles_per_block=plan.tiles_per_block,
            kahan=plan.precision == "kahan",
        )
        if census:
            return out[0].to(plan.accum_torch), out[1].to(plan.accum_torch)
        return out.to(plan.accum_torch)

    def moments_all(self, x, plan):
        _check_kernel_m(plan, self.name)
        if plan.precision == "kahan":
            raise ValueError(
                "kind='moments' does not compose with precision='kahan' on cuda_fused: the "
                "moments pair needs both accumulators, which the Kahan carry takes. Replan "
                "with precision='native', or compensate 'sum' and 'sumsq' separately")
        s, ss = _mma_ops.mma_moments_fused(x, compute_dtype=plan.compute_torch,
                                           num_lanes=self._lanes(x, plan),
                                           tiles_per_block=plan.tiles_per_block)
        return s.to(plan.accum_torch), ss.to(plan.accum_torch)

    def sum_segments(self, flat, offsets, plan, prologue="identity", epilogue=()):
        # ONE launch of the gather kernel, reading the stream in place
        _check_kernel_m(plan, self.name)
        out = _mma_ops.mma_sum_segments(
            flat, offsets, compute_dtype=plan.compute_torch, prologue=prologue,
            epilogue=epilogue, num_lanes=self._lanes(flat, plan),
        )
        return out.to(plan.accum_torch)

    def sum_parts(self, parts, plan, prologue="identity", epilogue=()):
        # ONE launch of the parts kernel, every part its own operand; past
        # PARTS_KERNEL_MAX live parts the base class packs them and takes
        # one sum_segments launch (the reference's route)
        _check_kernel_m(plan, self.name)
        live = sum(1 for p in parts if p.numel())
        if live > _mma_ops.PARTS_KERNEL_MAX:
            return super().sum_parts(parts, plan, prologue, epilogue)
        out = _mma_ops.mma_sum_parts(
            parts, compute_dtype=plan.compute_torch, prologue=prologue, slot_epilogue=epilogue,
        )
        return out.to(plan.accum_torch)

    def sum_parts_total(self, parts, plan, prologue="identity",
                        total_chains=((),), census=False):
        _check_kernel_m(plan, self.name)
        pros = _kcommon.normalize_part_prologues(prologue, len(parts))
        live = sum(1 for p in parts if p.numel())
        if "moments" in pros or live > _mma_ops.PARTS_KERNEL_MAX:
            return super().sum_parts_total(parts, plan, prologue, total_chains, census)
        out = _mma_ops.mma_sum_parts(
            parts, compute_dtype=plan.compute_torch, prologue=prologue,
            total_chains=tuple(total_chains), census=census,
        )
        return out.to(plan.accum_torch)

    def scan_axis(self, x, plan, inclusive=True, trace=None):
        # a 1-D stream: ONE launch of the scan kernel; batched rows ride the
        # triangular product (one launch per row would serialize them)
        _check_kernel_m(plan, self.name)
        if x.ndim > 1:
            return super().scan_axis(x, plan, inclusive)
        return _scan_ops.mma_scan(x, inclusive=inclusive, tiles_per_block=plan.tiles_per_block,
                                  num_lanes=plan.num_lanes, compute_dtype=plan.compute_torch,
                                  trace=trace)


class CudaHierBackend(CudaFusedBackend):
    """The paper's hierarchy on the level kernel (K10); parts and trees as
    cuda_fused."""

    name = "cuda_hier"
    native_kahan = False  # the blocked combine, its block sums batched

    def sum_all(self, x, plan, prologue="identity", epilogue=(), census=False):
        _check_kernel_m(plan, self.name)
        total = _mma_ops.mma_sum_hier(x, compute_dtype=plan.compute_torch, prologue=prologue,
                                      epilogue=epilogue, tiles_per_block=plan.tiles_per_block)
        total = total.to(plan.accum_torch)
        if census:
            return total, host_nonfinite_census([x], total.dtype)[-1]
        return total

    def moments_all(self, x, plan):
        _check_kernel_m(plan, self.name)
        s, ss = _mma_ops.mma_moments_hier(x, compute_dtype=plan.compute_torch,
                                          tiles_per_block=plan.tiles_per_block)
        return s.to(plan.accum_torch), ss.to(plan.accum_torch)

    def block_sums(self, flat, plan, prologue="identity"):
        _check_kernel_m(plan, self.name)
        return _mma_ops.mma_sum_hier_blocks(
            flat, plan.kahan_block, compute_dtype=plan.compute_torch, prologue=prologue,
            tiles_per_block=plan.tiles_per_block).to(plan.accum_torch)


class SegmentedBackend(Backend):
    """The registered "segmented" auto route: ``plan_for(..., segments=N)``
    sends multi-reduce problems here, and each call resolves its executor
    from the live problem (``plan.segmented_backend_for``: exact torch for
    non-float data, the kernels for large streams on a CUDA device,
    mma_torch elsewhere) and delegates, so a plan stays valid wherever it
    is replayed. The scalar and row primitives delegate the same way."""

    name = "segmented"
    native_autodiff = False  # it may resolve to a kernel backend

    def _delegate(self, n: int, dtype, device, plan):
        name = segmented_backend_for(n, dtype, plan.m, device, plan)
        return get_backend(name), plan.replace(backend=name)

    def sum_all(self, x, plan, prologue="identity", epilogue=(), census=False):
        b, p = self._delegate(x.numel(), x.dtype, x.device, plan)
        return b.sum_all(x, p, prologue, epilogue, census)

    def sum_axis(self, x, plan):
        b, p = self._delegate(x.shape[-1], x.dtype, x.device, plan)
        return b.sum_axis(x, p)

    def moments_axis(self, x, plan):
        b, p = self._delegate(x.shape[-1], x.dtype, x.device, plan)
        return b.moments_axis(x, p)

    def moments_all(self, x, plan):
        b, p = self._delegate(x.numel(), x.dtype, x.device, plan)
        return b.moments_all(x, p)

    def block_sums(self, flat, plan, prologue="identity"):
        b, p = self._delegate(flat.numel(), flat.dtype, flat.device, plan)
        return b.block_sums(flat, p, prologue)

    def sum_segments(self, flat, offsets, plan, prologue="identity", epilogue=()):
        b, p = self._delegate(flat.numel(), flat.dtype, flat.device, plan)
        return b.sum_segments(flat, offsets, p, prologue, epilogue)

    def _parts_delegate(self, parts, plan):
        total = sum(int(p.numel()) for p in parts)
        dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts), parts[0].dtype) \
            if parts else torch.float32
        return self._delegate(total, dtype, parts[0].device if parts else None, plan)

    def sum_parts(self, parts, plan, prologue="identity", epilogue=()):
        b, p = self._parts_delegate(parts, plan)
        return b.sum_parts(parts, p, prologue, epilogue)

    def sum_parts_total(self, parts, plan, prologue="identity", total_chains=((),),
                        census=False):
        b, p = self._parts_delegate(parts, plan)
        return b.sum_parts_total(parts, p, prologue, total_chains, census)


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend, name: str | None = None) -> Backend:
    _REGISTRY[name or backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown reduce backend {name!r}; available: "
            f"{', '.join(available_backends())}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(TorchBackend())
register_backend(MmaTorchBackend())
register_backend(CudaHierBackend())
register_backend(CudaFusedBackend())
register_backend(SegmentedBackend())
