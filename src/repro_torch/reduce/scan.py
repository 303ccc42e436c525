"""``repro_torch.scan``: prefix sums on the reduction engine's backends.

Port of ``repro/reduce/scan.py``: resolve a ``ScanPlan`` (auto, process
default or explicit, with quarantine), move the scanned axis last and flip
it for ``reverse``, run the backend's ``scan_axis``, and wrap the kernel
backends in a ``torch.autograd.Function`` whose backward is one more scan
under the same plan: d/dx of cumsum is the reversed cumsum of the
cotangent (inclusive for inclusive, exclusive for exclusive).

The result has x's shape and dtype on every backend. The compute dtype
defaults to the operand's own ingest dtype (``ScanPlan``): every partial of
a scan is an output, and the packing offsets rely on f32-exact integer
prefixes.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common as _kcommon
from repro_torch.reduce import backends as _backends
from repro_torch.reduce.plan import ScanPlan, dtype_name, scan_plan_for

SCAN_KINDS = ("cumsum",)


def _resolve_scan_plan(x: torch.Tensor, plan: Optional[ScanPlan], **fields) -> ScanPlan:
    """The given plan with the set keyword fields over it, or the planner's
    choice for x (its shape, dtype and device)."""
    if plan is None:
        return scan_plan_for(x.shape, x.dtype, device=x.device, **fields)
    over = {k: v for k, v in fields.items() if v is not None}
    if "compute_dtype" in over:
        over["compute_dtype"] = dtype_name(over["compute_dtype"])
    return plan.replace(**over) if over else plan


def _scan_impl(x: torch.Tensor, plan: ScanPlan, inclusive: bool, trace=None) -> torch.Tensor:
    return _backends.get_backend(plan.backend).scan_axis(x, plan, inclusive=inclusive,
                                                         trace=trace)


class _KScan(torch.autograd.Function):
    """A kernel-backed last-axis scan with the cumsum cotangent rule (the
    reference's ``_kscan``): y = cumsum(x) gives dx_i = sum_{k >= i} g_k,
    the reversed inclusive scan of g (exclusive: sum_{k > i} g_k, the
    reversed exclusive scan) -- one more scan under the same plan."""

    @staticmethod
    def forward(ctx, x, plan, inclusive):
        ctx.plan, ctx.inclusive = plan, inclusive
        return _scan_impl(x, plan, inclusive)

    @staticmethod
    def backward(ctx, g):
        dx = torch.flip(_scan_impl(torch.flip(g, (-1,)), ctx.plan, ctx.inclusive), (-1,))
        return dx, None, None


def scan(
    x,
    axis: int = -1,
    kind: str = "cumsum",
    inclusive: bool = True,
    reverse: bool = False,
    *,
    plan: Optional[ScanPlan] = None,
    backend: Optional[str] = None,
    m: Optional[int] = None,
    tiles_per_block: Optional[int] = None,
    num_lanes: Optional[int] = None,
    compute_dtype=None,
    trace: Optional[list] = None,
) -> torch.Tensor:
    """Prefix sum of ``x`` along ``axis`` on the engine's backends.

    ``inclusive=False`` gives the exclusive prefix (out[..., 0] == 0, the
    inclusive prefix shifted); ``reverse=True`` scans back to front (suffix
    sums). The result has x's shape and dtype. ``plan`` pins the strategy,
    the keyword fields override it (``num_lanes``: the scan kernel's lanes).
    ``trace`` (a list) gets the kernel's ``ScanTrace``; passing it takes the
    non-differentiable direct path. Runs on x's device.
    """
    if kind not in SCAN_KINDS:
        raise ValueError(f"unknown scan kind {kind!r}; expected one of {SCAN_KINDS}")
    x = torch.as_tensor(x)
    if x.ndim == 0:
        raise ValueError("scan needs an operand with at least one axis")
    ax = int(axis) % x.ndim
    moved = torch.movedim(x, ax, -1) if ax != x.ndim - 1 else x
    if reverse:
        moved = torch.flip(moved, (-1,))
    rplan = _resolve_scan_plan(moved, plan, backend=backend, m=m,
                               tiles_per_block=tiles_per_block, num_lanes=num_lanes,
                               compute_dtype=compute_dtype)
    bk = _backends.get_backend(rplan.backend)
    if bk.native_autodiff or trace is not None or not _kcommon.needs_grad(moved):
        out = bk.scan_axis(moved, rplan, inclusive=inclusive, trace=trace)
    else:
        out = _KScan.apply(moved, rplan, inclusive)
    if reverse:
        out = torch.flip(out, (-1,))
    return torch.movedim(out, -1, ax) if ax != x.ndim - 1 else out
