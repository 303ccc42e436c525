"""Prefix sums by triangular MMAs: the scan kernel (K9) and the batched
triangular product.

Port of ``repro/kernels/scan.py``:

  mma_scan        -- the triangular-MMA cumsum of a 1-D (or flattened)
                     operand in ONE launch (the counterpart of
                     ``mma_scan_pallas``; kernel ``scan_kernel``). CUDA:
                     ``csrc/scan.cu``.
  mma_scan_plain  -- its plain PyTorch version, on CPU tensors.
  mma_scan_torch  -- the batched scan over the last axis as one chunk @ U
                     product plus an exact f32 strip carry (the counterpart
                     of ``mma_scan_jnp``): torch code, not a kernel; the
                     ``mma_torch`` backend's scan and the kernel backends'
                     route for batched input.

Per m x m tile X (row-major): T1 = X @ J gives the row totals, D[i] their
fold over the rows before i (the reference's Ls @ T1), R = X @ U each row's
running prefix (U strictly upper for the exclusive scan), and the output is
(R + D) + carry in the storage dtype. The tile's total is read off the
corner D[m-1] + T1[m-1] and folded into the f32 carry strictly left to
right. The kernel runs one tile per CTA over the whole card and learns
each carry by a look-back over the tiles' published totals and inclusive
carries that keeps that chain of adds (csrc/scan.cu), so the output is
bitwise the plain version's on every run, whatever ``num_lanes`` and
``tiles_per_block`` say (accepted for parity with the reference's
``num_cores``; they change neither the launch nor its bytes). Its traffic
is ``cost_model.lookback_scan_hbm_bytes``, and the trace reports it; the
reference's striped model (``scan_hbm_bytes``, with its carry-rebuild
refetch) describes the reference's kernel only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.kernels import build, common

MXU = common.MXU
TILE = MXU * MXU


@dataclasses.dataclass(frozen=True)
class ScanTrace:
    """Instrumentation of one scan: the kernel's modeled bytes
    (``cost_model.lookback_scan_hbm_bytes``' total) and the bytes handed to
    and written by the launch (``launch_io_bytes``: input, output and
    look-back state, counted from the buffers the wrapper passes)."""

    n: int
    m: int
    hbm_bytes: int = 0        # the kernel's modeled traffic (no refetch)
    inclusive: bool = True
    fallback: str = ""        # "" (in place) or "ingest_f32"
    launch_io_bytes: int = 0


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).to(torch.float32)


def _row_prefix(rows: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """(k, m) -> each row's running f32 sum, left to right (inclusive), or
    the same shifted right by one (exclusive)."""
    out = torch.empty_like(rows)
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for j in range(rows.shape[1]):
        if not inclusive:
            out[:, j] = acc
        acc = acc + rows[:, j]
        if inclusive:
            out[:, j] = acc
    return out


def scan_tile_parts(flat: torch.Tensor, inclusive: bool = True, compute_dtype=None):
    """The per-tile half of the plain version: ``(r, down, totals)`` of the
    ``ceil(n / m^2)`` zero-padded tiles -- each row's running f32 prefix R
    (``(tiles, m, m)``), D (``(tiles, m)``) and the tile totals D[m-1] +
    T1[m-1] (``(tiles,)``), each value rounded to the compute dtype first."""
    flat = flat.reshape(-1)
    cd = flat.dtype if compute_dtype is None else compute_dtype
    n = flat.numel()
    tiles = max(1, common.ceil_div(n, TILE))
    v = _round(flat.to(torch.float32), cd)
    rows = torch.nn.functional.pad(v, (0, tiles * TILE - n)).view(tiles * MXU, MXU)
    incl = _row_prefix(rows, True)
    t1 = incl[:, -1].view(tiles, MXU)
    r = incl if inclusive else _row_prefix(rows, False)
    down = torch.empty_like(t1)
    d = torch.zeros(tiles, dtype=torch.float32, device=flat.device)
    for i in range(MXU):
        down[:, i] = d
        d = d + t1[:, i]
    return r.view(tiles, MXU, MXU), down, down[:, -1] + t1[:, -1]


def carry_chain(totals: torch.Tensor) -> torch.Tensor:
    """Each tile's carry: 0, then a left-to-right f32 fold of the tile
    totals, c[t + 1] = c[t] + total[t] (numpy's float32 accumulate is
    sequential)."""
    chain = np.cumsum(np.concatenate([np.zeros(1, np.float32),
                                      totals.cpu().numpy().astype(np.float32)]), dtype=np.float32)
    return torch.from_numpy(chain[:-1]).to(totals.device)


def scan_from_parts(r: torch.Tensor, down: torch.Tensor, carry: torch.Tensor,
                    dtype) -> torch.Tensor:
    """The tile-padded prefix (R + D) + carry, flat, in ``dtype``."""
    return ((r + down[:, :, None]) + carry[:, None, None]).reshape(-1).to(dtype)


def mma_scan_plain(flat: torch.Tensor, inclusive: bool = True,
                   compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the scan kernel: the tile-padded prefix
    (``ceil(n / m^2) * m^2`` values in the storage dtype). Each value is
    rounded to the compute dtype; each tile row is summed left to right in
    f32 (R; its last value is T1), D folds T1 over the rows left to right,
    the tile totals D[m-1] + T1[m-1] are folded left to right into the
    carry, and the output is (R + D) + carry. At f32 compute this is the
    kernel's arithmetic, bitwise; at bf16/f16 the kernel takes R and T1 on
    tensor cores, whose f32 accumulation order is the hardware's."""
    r, down, totals = scan_tile_parts(flat, inclusive, compute_dtype)
    return scan_from_parts(r, down, carry_chain(totals), flat.dtype)


def _ingest(x: torch.Tensor):
    flat = x.reshape(-1)
    if common.native_ingest_dtype(flat.dtype):
        return flat, ""
    return flat.to(torch.float32), "ingest_f32"


@common.counted("mma_scan")
def mma_scan(
    x: torch.Tensor,
    *,
    inclusive: bool = True,
    tiles_per_block: int = 8,
    num_lanes: int = 1,
    compute_dtype=None,
    trace: list | None = None,
) -> torch.Tensor:
    """Cumsum of every element of ``x`` in flat order, in ONE launch ->
    x's shape and dtype. Reads the buffer once in its own dtype (other than
    f32/bf16/f16: one f32 staging copy), writes the tile-padded prefix in
    the storage dtype and returns its first n values. ``compute_dtype=None``
    scans at the ingest dtype itself. ``num_lanes`` and ``tiles_per_block``
    shape the reference's striped kernel; here they are checked only (one
    CTA per tile over the whole card, carries by look-back: the output is
    the same, bit for bit, at any count and on every run).
    ``trace`` gets a ``ScanTrace``. CPU tensors: plain version. Not
    differentiable: an input that requires grad raises (``repro_torch.scan``
    differentiates it). Each launch publishes its look-back words under a
    fresh epoch drawn here, so a CUDA graph that replayed a captured launch
    would reuse a stale epoch: do not capture it."""
    common.refuse_grad("mma_scan", x, entry="repro_torch.scan")
    if num_lanes < 1:
        raise ValueError(f"num_lanes must be >= 1; got {num_lanes}")
    if tiles_per_block < 1:
        raise ValueError(f"tiles_per_block must be >= 1; got {tiles_per_block}")
    flat, fallback = _ingest(x)
    cd = flat.dtype if compute_dtype is None else compute_dtype
    if cd not in common.NATIVE_INGEST_DTYPES:
        raise ValueError(f"compute dtype must be one of {common.NATIVE_INGEST_DTYPES}; got {cd}")
    n = flat.numel()
    if n == 0:
        if trace is not None:
            trace.append(ScanTrace(n=0, m=MXU, inclusive=inclusive))
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    tiles = common.ceil_div(n, TILE)
    itemsize = flat.element_size()
    # the stream in, the tile-padded prefix and the look-back words out
    read, write = n * itemsize, tiles * TILE * itemsize + 8 * (tiles + 1)
    if trace is not None:
        hbm = cost_model.lookback_scan_hbm_bytes(n, itemsize, m=MXU)
        trace.append(ScanTrace(n=n, m=MXU, hbm_bytes=hbm.total, inclusive=inclusive,
                               fallback=fallback, launch_io_bytes=read + write))
    if common.on_cpu(flat):
        common.record_io(mma_scan, (read, write), plain=True)
        out = mma_scan_plain(flat, inclusive, cd)
    else:
        src = flat.contiguous()
        out = torch.empty((tiles * TILE,), dtype=src.dtype, device=src.device)
        stream = build.stream_ptr(out)
        state, epoch = common.fold_tickets("mma_scan", src.device, stream, tiles + 1,
                                           torch.int64, epoch=True)
        with torch.cuda.device(src.device):
            err = build.library().sc_scan(
                src.data_ptr(), n, build.dtype_code(src), build.DTYPE_CODES[cd],
                int(bool(inclusive)), int(src.data_ptr() % 16 == 0), out.data_ptr(),
                state.data_ptr(), epoch, stream,
            )
        build.check(err, "mma_scan")
        common.record_io(mma_scan, (read, write))
    return out[:n].reshape(x.shape).to(x.dtype)


def mma_scan_torch(x: torch.Tensor, *, inclusive: bool = True, m: int = MXU,
                   compute_dtype=None) -> torch.Tensor:
    """The triangular scan over the LAST axis of any rank (the reference's
    ``mma_scan_jnp``): each row cut into (k, m) strips, every strip times
    U in one batched product (f32 accumulation of operands rounded to the
    compute dtype), and the strip carry the f32 cumsum of the strip
    totals, shifted (never ``cumsum - x``). Result in x's dtype."""
    orig = x.dtype
    xf = x if common.native_ingest_dtype(x.dtype) else x.to(torch.float32)
    cd = xf.dtype if compute_dtype is None else compute_dtype
    length = x.shape[-1]
    if length == 0:
        return torch.zeros(x.shape, dtype=orig, device=x.device)
    k = common.ceil_div(length, m)
    chunks = torch.nn.functional.pad(xf, (0, k * m - length))
    chunks = _round(chunks.reshape(x.shape[:-1] + (k, m)).to(torch.float32), cd)
    upper = common.triu_tile(m, torch.float32, 0 if inclusive else 1, device=x.device)
    rowpref = chunks @ upper  # products with 0/1 are exact: an f32-accumulated MMA
    totals = rowpref[..., m - 1]
    if not inclusive:
        totals = totals + chunks[..., m - 1]
    carry = torch.cumsum(totals, dim=-1)
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], dim=-1)
    out = rowpref + carry[..., None]
    return out.reshape(x.shape[:-1] + (k * m,))[..., :length].to(orig)
