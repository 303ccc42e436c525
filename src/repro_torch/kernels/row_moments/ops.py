"""Fused row-moment norms: non-parametric LayerNorm (OLMo) and RMSNorm.

Port of ``repro/kernels/row_moments`` (``layernorm_np_kernel`` and
``rmsnorm_kernel``, with the custom VJPs of its ``ops.py``). On CUDA
tensors the forward launches ``csrc/row_moments.cu``; on CPU tensors it
runs the plain versions below, which round exactly where the kernel does:
x and the f32 square x*x are each rounded to bf16 before the all-ones row
sum, accumulated in f32.

Differentiable: with grad mode on and an input that requires grad, the
wrappers go through ``torch.autograd.Function``s whose backward is the
reference's host math (``_ln_bwd`` / ``_rms_bwd``) in torch, recomputing
the statistics from the saved input (no residual but the inputs).

The kernel (one launch a call) keeps each row in registers between its one
read and its one write: a group of warps a row, each lane holding up to 8
16-byte chunks, its statistics ones-MMAs on the values the lane holds (see
the file's header for the fold order). ``launch_plan`` picks, on the host,
per call:

  route          ``vector`` (16-byte loads and stores) when x and gamma lie
                 on a 16-byte aligned base and a row is a multiple of 16
                 bytes, else ``element`` (masked element loads and stores,
                 each of a warp's reading 32 adjacent columns): any base
                 and any d >= 1, and x is never copied to align it;
  geometry       warps a row, so that a lane holds at most 8 chunks and,
                 below 1024 warps in all (decode rows), more warps split
                 each row while each lane keeps two chunks; rows a CTA (up
                 to 4 warps a CTA). ``tools/norm_probe.py`` times the
                 alternatives on the card;
  slabs          1, or, for rows longer than 16 warps x 32 lanes x 8
                 chunks, the re-read: statistics over every slab, then the
                 normalisation re-reads each slab.

Gamma reaches the kernel in its own dtype (f32, bf16 or f16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, common

# csrc/row_moments.cu: Route, RM_MAX_CHUNKS, RM_MAX_THREADS
ROUTE_VECTOR, ROUTE_ELEMENT = 0, 1
ROUTE_NAMES = {ROUTE_VECTOR: "vector", ROUTE_ELEMENT: "element"}
MAX_CHUNKS = 8
MAX_WARPS_PER_ROW = 16
# Below this many warps in the grid, rows take more warps each (while every
# lane keeps two chunks); a CTA holds at most CTA_WARPS warps where a row
# takes fewer.
FILL_WARPS = 1024
CTA_WARPS = 4


class Plan(NamedTuple):
    """One launch of the norm kernel: its route and geometry."""

    route: int
    warps_per_row: int
    rows_per_cta: int
    chunks: int  # 16-byte chunks a lane holds
    slabs: int  # > 1: the re-read (a row longer than the registers hold)

    @property
    def name(self) -> str:
        reread = f", re-read in {self.slabs} slabs" if self.slabs > 1 else ""
        return (f"{ROUTE_NAMES[self.route]}{reread} (warps/row {self.warps_per_row}, "
                f"rows/CTA {self.rows_per_cta}, chunks/lane {self.chunks})")


def launch_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The kernel's route and geometry for ``rows`` rows of ``d`` elements of
    ``dtype``; ``aligned``: x (and gamma) start on a 16-byte boundary."""
    itemsize = dtype.itemsize
    per_chunk = 16 // itemsize
    route = ROUTE_VECTOR if aligned and d * itemsize % 16 == 0 else ROUTE_ELEMENT
    nchunks = -(-d // per_chunk)
    warps = min(MAX_WARPS_PER_ROW, -(-nchunks // (32 * MAX_CHUNKS)))
    while (2 * warps <= MAX_WARPS_PER_ROW and rows * warps < FILL_WARPS
           and 128 * warps <= nchunks):  # every lane keeps two chunks
        warps *= 2
    slabs = -(-nchunks // (32 * warps * MAX_CHUNKS))
    chunks = -(-nchunks // (32 * warps * slabs))
    return Plan(route, warps, max(1, min(rows, CTA_WARPS // warps)), chunks, slabs)


def plan_for(x: torch.Tensor, gamma: torch.Tensor | None = None) -> Plan:
    """``launch_plan`` for a contiguous x (..., d) and gamma (d,) as they
    lie in memory."""
    aligned = x.data_ptr() % 16 == 0 and (gamma is None or gamma.data_ptr() % 16 == 0)
    d = x.shape[-1]
    return launch_plan(x.numel() // max(d, 1), d, x.dtype, aligned)


def _bf16_row_sum(x: torch.Tensor) -> torch.Tensor:
    """(R, d) f32 -> (R,): the ones-MMA row sum of bf16(x) with f32
    accumulation (bf16 * 1 is exact in f32, so an f32 sum of the rounded
    values is the same product)."""
    return torch.sum(x.to(torch.bfloat16).to(torch.float32), dim=-1)


def layernorm_np_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the layernorm_np kernel, last axis."""
    xf = x.to(torch.float32)
    d = x.shape[-1]
    s = _bf16_row_sum(xf)
    ss = _bf16_row_sum(xf * xf)
    mu = s / d
    var = torch.clamp_min(ss / d - mu * mu, 0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return ((xf - mu[..., None]) * rstd[..., None]).to(x.dtype)


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the rmsnorm kernel, last axis."""
    xf = x.to(torch.float32)
    d = x.shape[-1]
    ss = _bf16_row_sum(xf * xf)
    rstd = 1.0 / torch.sqrt(ss / d + eps)
    return (xf * rstd[..., None] * gamma.to(torch.float32)).to(x.dtype)


def _check_rows(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    if d >= 2**30 or x.numel() // max(d, 1) >= 2**31:
        raise ValueError("too many rows or too long a row for one launch")
    return x.contiguous()


def _layernorm_np_forward(x: torch.Tensor, eps: float) -> torch.Tensor:
    if common.on_cpu(x):
        common.record_io(layernorm_np, (common.nbytes(x), common.nbytes(x)), plain=True)
        return layernorm_np_plain(x, eps)
    x = _check_rows(x)
    out = torch.empty_like(x)
    if x.numel():
        p = plan_for(x)
        with torch.cuda.device(x.device):
            err = build.library().rm_layernorm_np(
                x.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], float(eps),
                build.dtype_code(x), p.route, p.warps_per_row, p.rows_per_cta, p.chunks,
                p.slabs, build.stream_ptr(x),
            )
        build.check(err, "layernorm_np")
        common.record_io(layernorm_np, (common.nbytes(x), common.nbytes(out)))
    return out


def _rmsnorm_forward(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    if common.on_cpu(x, gamma):
        common.record_io(rmsnorm, (common.nbytes(x, gamma), common.nbytes(x)), plain=True)
        return rmsnorm_plain(x, gamma, eps)
    x = _check_rows(x)
    if gamma.shape != (x.shape[-1],):
        raise ValueError(f"gamma must have shape ({x.shape[-1]},); got {tuple(gamma.shape)}")
    if gamma.dtype not in build.DTYPE_CODES:  # the kernel reads f32, bf16 and f16
        gamma = gamma.to(torch.float32)
    gamma = gamma.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        p = plan_for(x, gamma)
        with torch.cuda.device(x.device):
            err = build.library().rm_rmsnorm(
                x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1],
                x.shape[-1], float(eps), build.dtype_code(x), build.dtype_code(gamma), p.route,
                p.warps_per_row, p.rows_per_cta, p.chunks, p.slabs, build.stream_ptr(x),
            )
        build.check(err, "rmsnorm")
        common.record_io(rmsnorm, (common.nbytes(x, gamma), common.nbytes(out)))
    return out


def layernorm_np_bwd(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """d/dx of the non-parametric LayerNorm: the reference's ``_ln_bwd``."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    xc = xf - mu
    var = torch.mean(xc * xc, -1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dx = rstd * (
        gf
        - torch.mean(gf, -1, keepdim=True)
        - xhat * torch.mean(gf * xhat, -1, keepdim=True)
    )
    return dx.to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor, eps: float):
    """(dx, dgamma) of RMSNorm: the reference's ``_rms_bwd``."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    gam = gamma.to(torch.float32)
    d = x.shape[-1]
    ms = torch.mean(xf * xf, -1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    xhat = xf * rstd
    dgamma = torch.sum((gf * xhat).reshape(-1, d), 0).to(gamma.dtype)
    gg = gf * gam
    dx = rstd * gg - xf * (rstd**3) * torch.mean(gg * xf, -1, keepdim=True)
    return dx.to(x.dtype), dgamma


class _LayerNormNP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _layernorm_np_forward(x, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return layernorm_np_bwd(x, g, ctx.eps), None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rmsnorm_forward(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rmsnorm_bwd(x, gamma, g, ctx.eps)
        return dx, dgamma, None


@common.counted("layernorm_np")
def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo) over the last axis; any leading
    shape. CPU tensor: plain version; CUDA tensor: the kernel.
    Differentiable (host-math backward)."""
    if common.needs_grad(x):
        return _LayerNormNP.apply(x, eps)
    return _layernorm_np_forward(x, eps)


@common.counted("rmsnorm")
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, scaled by ``gamma``; any leading shape.
    CPU tensors: plain version; CUDA tensors: the kernel. Differentiable in
    x and gamma (host-math backward)."""
    if common.needs_grad(x, gamma):
        return _RMSNorm.apply(x, gamma, eps)
    return _rmsnorm_forward(x, gamma, eps)
