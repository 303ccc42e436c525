"""Precision tools for low-precision MMA reductions.

Port of ``repro/core/precision.py``. The paper (section V) leaves the
precision lost by fp16 reductions as future work and cites Kahan
summation and iterative refinement as remedies:

  kahan_sum          -- compensated serial summation (error O(1) in n);
  blocked_kahan_mma  -- the MMA hierarchy per block, Kahan over the block
                        totals;
  relative_error / ulps -- the error metrics of the demo and the chip run.

The pairwise bound comes from ``core.mma_reduce.classic_tree_sum``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mma_reduce

_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16}


def kahan_sum(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kahan-compensated serial sum at ``dtype``: the reference's scan,
    step by step (y = x_i - c; t = s + y; c = (t - s) - y; s = t), one
    element at a time in order. It runs on the host over numpy scalars of
    ``dtype`` (each operation rounds to that width), so it is meant for
    short vectors of partials."""
    if dtype not in _NP:
        raise ValueError(f"kahan_sum runs at float16/32/64; got {dtype}")
    ty = _NP[dtype]
    v = x.detach().reshape(-1).to(dtype).cpu().numpy()
    s, c = ty(0), ty(0)
    for xi in v:
        y = xi - c
        t = s + y
        c = (t - s) - y
        s = t
    return torch.tensor(s, dtype=dtype, device=x.device)


def blocked_kahan_mma(x: torch.Tensor, *, m: int = mma_reduce.DEFAULT_M,
                      block: int = 4096) -> torch.Tensor:
    """The MMA hierarchy over each block of ``block`` elements (zero-padded;
    f32 accumulation, the reference's default multiplier width), then a
    Kahan pass over the block totals: the MMA does the long inner sums, the
    short cross-block combine is compensated."""
    flat = x.reshape(-1)
    nblk = -(-flat.numel() // block)
    flat = torch.nn.functional.pad(flat, (0, nblk * block - flat.numel()))
    partials, _, _ = mma_reduce.mma_sum_rows(
        flat.view(nblk, block), m=m, compute_dtype=mma_reduce.default_compute_dtype(x.dtype))
    return kahan_sum(partials)


def relative_error(approx, exact) -> float:
    """|approx - exact| / |exact|, in f64."""
    a, e = float(approx), float(exact)
    return abs(a - e) / max(abs(e), 1e-300)


def ulps(approx, exact, dtype=np.float32) -> float:
    """|approx - exact| in units of the last place of ``exact`` at
    ``dtype`` (the spacing of that width next to the exact value)."""
    e = float(exact)
    return abs(float(approx) - e) / float(np.spacing(np.asarray(abs(e), dtype=dtype)))
