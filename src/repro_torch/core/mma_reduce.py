"""Row reductions as all-ones matrix products (the paper's eq. 9).

Port of ``row_sum_mma`` / ``row_moments_mma`` of
``repro/core/mma_reduce.py``: the ``mma_torch`` backend's row path, which
decode attention's softmax denominator uses. The operand is rounded to the
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
