"""Backend registry: the interchangeable executors behind ``repro_torch.reduce``.

Port of the serving and training paths' part of
``repro/reduce/backends.py``. A backend supplies five primitives:

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
  sum_parts(parts, plan, prologue)
                          -- S separate arrays -> (S,) prologue-mapped sums
  sum_parts_total(parts, plan, prologue, total_chains, census)
                          -- (S,) sums, then chain k of the cross-part total
                             at slot S + k, then (census) S + 1 non-finite
                             counts: the row behind ``reduce_tree``

Registered here (analogues of the reference's xla / mma_jnp /
pallas_hier / pallas_fused):

  torch       -- plain ``torch.sum`` at accumulator precision; the oracle.
  mma_torch   -- the paper's algorithm as all-ones matmuls
                 (``core.mma_reduce``): full reductions by the eq. 13
                 hierarchy, rows via one ones-product, parts as rows of m
                 plus an exact f32 fold of the row partials.
  cuda_fused  -- the kernels: a full reduction is ONE launch of the fused
                 kernel (``kernels.mma_reduce.mma_sum_fused``, K1) with the
                 prologue at the compute dtype, the chain and the census in
                 the launch; a tree is ONE launch of the parts kernel
                 (``mma_sum_parts``, K4), every part its own operand, mapped
                 in-kernel (``native_prologue``). Rows ride the same
                 ones-product as mma_torch. Past ``PARTS_KERNEL_MAX`` live
                 parts it folds host-side through the base class, as the
                 reference's kernel backends do. ``precision="kahan"`` is
                 the compensated kernel K3 (``native_kahan``: one launch);
                 full moments the moments kernel K2 (one launch).
  cuda_hier   -- the paper's hierarchy (eq. 13) on the level kernel
                 (``mma_sum_hier``, K10): one launch per level, full moments
                 from one dual level-0 launch and a hierarchy per column,
                 the blocked compensated combine's block sums in one launch
                 per level. Rows, parts and trees as cuda_fused. It has no
                 census column: with ``census`` the count is taken on the
                 host beside the hierarchy's total.

``torch`` and ``mma_torch`` are torch code and differentiate natively
(``native_autodiff``); the kernel backends' full reductions differentiate
through ``reduce.api``'s ``_KSum`` and ``_KMoments`` Functions.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import mma_reduce as _core
from repro_torch.kernels import common as _kcommon
from repro_torch.kernels.mma_reduce import ops as _mma_ops
from repro_torch.reduce.plan import ReducePlan


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

    def _part_sum(self, flat: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
        raise NotImplementedError

    def sum_parts(self, parts: Sequence[torch.Tensor], plan: ReducePlan,
                  prologue="identity") -> torch.Tensor:
        """``out[s] = sum(P_s(parts[s]))`` over separate arrays, each mapped
        at accumulator precision; empty parts give 0."""
        pros = _kcommon.normalize_part_prologues(prologue, len(parts))
        if "moments" in pros:
            raise NotImplementedError("'moments' parts are not ported")
        accum = plan.accum_torch
        if not parts:
            return torch.zeros((0,), dtype=accum)
        outs = []
        for p, pro in zip(parts, pros):
            flat = _host_prologue(p.reshape(-1), plan, pro)
            outs.append(
                self._part_sum(flat, plan) if flat.numel()
                else torch.zeros((), dtype=accum, device=p.device)
            )
        return torch.stack(outs).to(accum)

    def sum_parts_total(self, parts, plan: ReducePlan, prologue="identity",
                        total_chains: tuple = ((),), census: bool = False):
        """Per-part sums, chain k of their total at slot S + k and, with
        ``census``, S + 1 non-finite counts -- host-side fold (reference
        semantics); cuda_fused finishes all of it in its launch."""
        per = self.sum_parts(parts, plan, prologue)
        total = torch.sum(per)
        totals = torch.stack([_kcommon.apply_epilogue(total, ch) for ch in total_chains])
        pieces = [per, totals.to(per.dtype)]
        if census:
            pieces.append(host_nonfinite_census(parts, per.dtype))
        return torch.cat(pieces)


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

    def _part_sum(self, flat, plan):
        return torch.sum(flat)

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

    def _part_sum(self, flat, plan):
        # zero-padded rows of m through ONE ones-product, then an exact f32
        # fold of the row partials (the upper rungs of the hierarchy)
        m = plan.m
        rows = _kcommon.ceil_div(flat.numel(), m)
        padded = torch.nn.functional.pad(flat, (0, rows * m - flat.numel()))
        return torch.sum(self.sum_axis(padded.view(rows, m), plan))

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

    def sum_parts(self, parts, plan, prologue="identity"):
        live = sum(1 for p in parts if p.numel())
        if live > _mma_ops.PARTS_KERNEL_MAX:
            return super().sum_parts(parts, plan, prologue)
        out = _mma_ops.mma_sum_parts(
            parts, compute_dtype=plan.compute_torch, prologue=prologue,
        )
        return out.to(plan.accum_torch)

    def sum_parts_total(self, parts, plan, prologue="identity",
                        total_chains=((),), census=False):
        live = sum(1 for p in parts if p.numel())
        if live > _mma_ops.PARTS_KERNEL_MAX:
            return super().sum_parts_total(parts, plan, prologue, total_chains, census)
        out = _mma_ops.mma_sum_parts(
            parts, compute_dtype=plan.compute_torch, prologue=prologue,
            total_chains=tuple(total_chains), census=census,
        )
        return out.to(plan.accum_torch)


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
