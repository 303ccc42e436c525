"""Reductions as all-ones matrix products (the paper's eqs. 9-13).

Port of ``row_sum_mma`` / ``row_moments_mma`` / ``mma_sum`` of
``repro/core/mma_reduce.py``: the ``mma_torch`` backend's row path (decode
attention's softmax denominator, the non-kernel CE) and its full
reduction (the hierarchy of eq. 13). The operand is rounded to the
compute dtype, then multiplied by an all-ones column with f32
accumulation. PyTorch's low-precision matmul would round its OUTPUT to the
compute dtype, so the rounded operand is lifted to the accumulator dtype
first: a product with 1 is exact, so this is the same f32-accumulated MMA.
(Set ``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default,
for full f32 products on the card.)

Also here, as in the reference: ``ReductionTrace`` (levels, model steps
and MMAs of one reduction, with the bytes of the kernel paths), ``mma_mean``
and ``classic_tree_sum``, the paper's pairwise baseline.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# The paper's tile size as the kernels run it; the paper uses m = 16 (the
# WMMA tile) and m = 4 (the V100 hardware tile), which mma_torch sweeps.
DEFAULT_M = 128


@dataclasses.dataclass(frozen=True)
class ReductionTrace:
    """Instrumentation record of one reduction (the reference's).

    ``levels``       -- two-MMA passes (launches, on the kernel paths).
    ``mma_ops``      -- m x m MMAs issued over all levels.
    ``model_steps``  -- the paper's unit cost: 5 per level (eq. 15).
    ``num_cores`` / ``lane_mma_ops`` / ``combine_mma_ops``
                     -- the striped fused kernels: lanes, MMAs per lane,
                        and the collapse/fold MMAs after the lanes join.
    ``hbm_bytes``    -- the modeled bytes (``core.cost_model``); 0 when not
                        modeled.
    ``fallback``     -- "" on the zero-copy route, else the staging taken
                        ("ingest_f32": the pre-cast of int/f64 input).
    ``census``       -- the pass also counted NaN/Inf.
    ``launch_io_bytes`` -- bytes of the tensors actually handed to and
                        written by the launches (the kernel paths of the
                        port; 0 elsewhere), to hold against the model's
                        ``launch_io``.
    """

    n: int
    m: int
    levels: int
    mma_ops: int
    num_cores: int = 1
    lane_mma_ops: int = 0
    combine_mma_ops: int = 0
    hbm_bytes: int = 0
    fallback: str = ""
    census: bool = False
    launch_io_bytes: int = 0

    @property
    def model_steps(self) -> int:
        return 5 * self.levels

    @property
    def predicted_steps(self) -> float:
        """Paper eq. (16): T_tc(n) = 5 log_{m^2}(n)."""
        return 5.0 * math.log(max(self.n, 2), self.m**2)


def _ones_col(length: int, dtype, device) -> torch.Tensor:
    return torch.ones((length, 1), dtype=dtype, device=device)


def row_sum_mma(
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sum over the last axis via one all-ones MMA: (..., L) -> (...)."""
    xc = x.to(compute_dtype).to(accum_dtype)
    return torch.matmul(xc, _ones_col(x.shape[-1], accum_dtype, x.device))[..., 0]


def row_moments_mma(
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) over the last axis, both as all-ones MMAs of
    one stacked operand. The square is taken at accumulator precision and
    rounded to the compute dtype, as in the reference."""
    xa = x.to(accum_dtype)
    stacked = torch.stack([xa.to(compute_dtype), (xa * xa).to(compute_dtype)], 0)
    out = torch.matmul(stacked.to(accum_dtype), _ones_col(x.shape[-1], accum_dtype, x.device))
    return out[0, ..., 0], out[1, ..., 0]


def default_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The reference's default multiplier width: bf16 for floats up to 32
    bits, f64 for f64, f32 for integer and bool data."""
    if dtype == torch.float64:
        return torch.float64
    return torch.bfloat16 if dtype.is_floating_point else torch.float32


def mma_sum_rows(
    x: torch.Tensor,
    *,
    m: int = DEFAULT_M,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_dtype: torch.dtype = torch.float32,
):
    """Each row of a (B, L) tensor reduced by the eq. 13 hierarchy on its
    own, all rows at once: zero-padded groups of m^2, two all-ones products
    per group -- D = A @ 1 (row sums), then 1 @ D with D re-entering at the
    compute dtype -- until one value per row is left. Returns ``((B,),
    levels, mma_ops per row)``; row b is what ``mma_sum`` gives for
    ``x[b]``."""
    if m < 2:
        raise ValueError(f"m must be >= 2 (paper section V); got {m}")
    group = m * m
    flat = x.to(accum_dtype)
    b = flat.shape[0]
    levels = mma_ops = 0
    while flat.shape[1] > 1:
        k = -(-flat.shape[1] // group)
        flat = torch.nn.functional.pad(flat, (0, k * group - flat.shape[1]))
        rows = row_sum_mma(flat.reshape(b * k * m, m), compute_dtype=compute_dtype,
                           accum_dtype=accum_dtype)
        flat = row_sum_mma(rows.view(b * k, m), compute_dtype=compute_dtype,
                           accum_dtype=accum_dtype).view(b, k)
        levels += 1
        mma_ops += 2 * k
    return flat[:, 0], levels, mma_ops


def mma_sum(
    x: torch.Tensor,
    *,
    m: int = DEFAULT_M,
    compute_dtype: torch.dtype | None = None,
    accum_dtype: torch.dtype = torch.float32,
    trace: list | None = None,
) -> torch.Tensor:
    """Reduce ``x`` to a scalar with the paper's hierarchical two-MMA
    algorithm (eq. 13): split into zero-padded groups of m^2, reduce each
    group with two all-ones products -- D = A @ 1 (row sums), then 1 @ D
    with D re-entering at the compute dtype -- and recurse on the group
    sums until one is left. ``compute_dtype`` defaults as in the reference
    (``default_compute_dtype``). ``trace``: a list that gets one
    ``ReductionTrace``."""
    if m < 2:
        raise ValueError(f"m must be >= 2 (paper section V); got {m}")
    if compute_dtype is None:
        compute_dtype = default_compute_dtype(x.dtype)
    flat = x.reshape(1, -1)
    n = flat.shape[1]
    if n == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=m, levels=0, mma_ops=0))
        return torch.zeros((), dtype=accum_dtype, device=x.device)
    out, levels, mma_ops = mma_sum_rows(flat, m=m, compute_dtype=compute_dtype,
                                        accum_dtype=accum_dtype)
    if trace is not None:
        trace.append(ReductionTrace(n=n, m=m, levels=levels, mma_ops=mma_ops))
    return out.reshape(())


def mma_mean(x: torch.Tensor, **kw) -> torch.Tensor:
    return mma_sum(x, **kw) / x.numel()


def classic_tree_sum(
    x: torch.Tensor,
    *,
    accum_dtype: torch.dtype = torch.float32,
    trace: list | None = None,
) -> torch.Tensor:
    """The classic pairwise GPU reduction (the paper's baseline): zero-pad
    to a power of two, then ``x[i] += x[i + p/2]`` halving passes, the
    summation tree of the CUDA kernel. T(n) = 4 log2(n) in the paper's
    model; the trace carries m = 2 so its ``model_steps`` line up, and 0
    MMAs."""
    flat = x.reshape(-1).to(accum_dtype)
    n0 = flat.numel()
    if n0 == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=2, levels=0, mma_ops=0))
        return torch.zeros((), dtype=accum_dtype, device=x.device)
    size = 1 << max(0, (n0 - 1).bit_length())
    flat = torch.nn.functional.pad(flat, (0, size - n0))
    levels = 0
    while flat.numel() > 1:
        half = flat.numel() // 2
        flat = flat[:half] + flat[half:]
        levels += 1
    if trace is not None:
        trace.append(ReductionTrace(n=n0, m=2, levels=levels, mma_ops=0))
    return flat.reshape(())
