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
"""

from __future__ import annotations

import torch


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


def mma_sum(
    x: torch.Tensor,
    *,
    m: int = 128,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Reduce ``x`` to a scalar with the paper's hierarchical two-MMA
    algorithm (eq. 13): split into zero-padded groups of m^2, reduce each
    group with two all-ones products -- D = A @ 1 (row sums), then 1 @ D
    with D re-entering at the compute dtype -- and recurse on the group
    sums until one is left."""
    if m < 2:
        raise ValueError(f"m must be >= 2 (paper section V); got {m}")
    group = m * m
    flat = x.reshape(-1).to(accum_dtype)
    if flat.numel() == 0:
        return torch.zeros((), dtype=accum_dtype, device=x.device)
    while flat.numel() > 1:
        k = -(-flat.numel() // group)
        flat = torch.nn.functional.pad(flat, (0, k * group - flat.numel()))
        rows = row_sum_mma(flat.view(k * m, m), compute_dtype=compute_dtype,
                           accum_dtype=accum_dtype)
        flat = row_sum_mma(rows.view(k, m), compute_dtype=compute_dtype,
                           accum_dtype=accum_dtype)
    return flat.reshape(())
