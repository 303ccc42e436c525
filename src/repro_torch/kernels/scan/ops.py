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
right, so a tile's carry is the same chain of adds at every lane count:
lanes own contiguous block ranges and rebuild their carry by re-reading the
tiles before them (``cost_model.scan_hbm_bytes``' refetch), and the output
is bitwise the same at any lane count.
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
    """Instrumentation of one scan (the reference's fields): geometry, the
    modeled MMAs and bytes, and the bytes handed to and written by the
    launch (``launch_io_bytes``, the port's, to hold against the model's
    ``launch_io``)."""

    n: int
    m: int
    num_cores: int = 1
    mma_ops: int = 0          # chip-wide MMAs (cost_model.ScanMmaOps.total)
    lane_mma_ops: int = 0     # one lane's owned-stripe MMAs
    carry_mma_ops: int = 0    # the worst lane's carry-rebuild MMAs
    hbm_bytes: int = 0        # modeled total traffic (refetch included)
    inclusive: bool = True
    fallback: str = ""        # "" (in place) or "ingest_f32"
    launch_io_bytes: int = 0


def scan_geometry(n: int, m: int = MXU, tiles_per_block: int = 8, num_cores: int = 1):
    """``(r, c, blocks_per_lane, padded_tiles)`` of a scan over n elements:
    ``cost_model.stripe_geometry``, with each lane's blocks contiguous."""
    tiles = max(1, common.ceil_div(n, m * m))
    return cost_model.stripe_geometry(tiles, tiles_per_block, num_cores)


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


def mma_scan_plain(flat: torch.Tensor, inclusive: bool = True, compute_dtype=None,
                   tiles_per_block: int = 8, num_lanes: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the scan kernel: the block-padded prefix
    (``padded_tiles * m^2`` values in the storage dtype). Each value is
    rounded to the compute dtype; each tile row is summed left to right in
    f32 (R; its last value is T1), D folds T1 over the rows left to right,
    the tile totals D[m-1] + T1[m-1] are folded left to right into the
    carry, and the output is (R + D) + carry. At f32 compute this is the
    kernel's arithmetic, bitwise; at bf16/f16 the kernel takes R and T1 on
    tensor cores, whose f32 accumulation order is the hardware's. The
    result does not depend on ``num_lanes`` (only the padding does)."""
    flat = flat.reshape(-1)
    cd = flat.dtype if compute_dtype is None else compute_dtype
    n = flat.numel()
    _, _, _, tpad = scan_geometry(n, MXU, tiles_per_block, num_lanes)
    v = _round(flat.to(torch.float32), cd)
    rows = torch.nn.functional.pad(v, (0, tpad * TILE - n)).view(tpad * MXU, MXU)
    incl = _row_prefix(rows, True)
    t1 = incl[:, -1].view(tpad, MXU)
    r = incl if inclusive else _row_prefix(rows, False)
    down = torch.empty_like(t1)
    d = torch.zeros(tpad, dtype=torch.float32, device=flat.device)
    for i in range(MXU):
        down[:, i] = d
        d = d + t1[:, i]
    totals = down[:, -1] + t1[:, -1]
    # the carry: 0, then a left-to-right f32 fold of the tile totals
    # (numpy's float32 accumulate is sequential)
    chain = np.cumsum(np.concatenate([np.zeros(1, np.float32),
                                      totals.cpu().numpy().astype(np.float32)]), dtype=np.float32)
    carry = torch.from_numpy(chain[:-1]).to(flat.device)
    out = (r.view(tpad, MXU, MXU) + down[:, :, None]) + carry[:, None, None]
    return out.reshape(-1).to(flat.dtype)


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
    f32/bf16/f16: one f32 staging copy), writes the block-padded prefix in
    the storage dtype and returns its first n values. ``compute_dtype=None``
    scans at the ingest dtype itself. ``num_lanes`` CTAs own contiguous
    block ranges and rebuild their carries by re-reading (clamped to the
    block count); the output is the same, bit for bit, at any count.
    ``trace`` gets a ``ScanTrace``. CPU tensors: plain version. Not
    differentiable: an input that requires grad raises (``repro_torch.scan``
    differentiates it)."""
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
    r, c, bpl, tpad = scan_geometry(n, MXU, tiles_per_block, num_lanes)
    itemsize = flat.element_size()
    if trace is not None:
        ops = cost_model.scan_mma_ops(n, MXU, num_lanes, tiles_per_block)
        hbm = cost_model.scan_hbm_bytes(n, itemsize, m=MXU, num_cores=num_lanes,
                                        tiles_per_block=tiles_per_block)
        trace.append(ScanTrace(n=n, m=MXU, num_cores=c, mma_ops=ops.total,
                               lane_mma_ops=ops.lane_scan, carry_mma_ops=ops.carry_worst,
                               hbm_bytes=hbm.total, inclusive=inclusive, fallback=fallback,
                               launch_io_bytes=n * itemsize + tpad * TILE * itemsize))
    if common.on_cpu(flat):
        out = mma_scan_plain(flat, inclusive, cd, tiles_per_block, num_lanes)
    else:
        src = flat.contiguous()
        out = torch.empty((tpad * TILE,), dtype=src.dtype, device=src.device)
        with torch.cuda.device(src.device):
            err = build.library().sc_scan(
                src.data_ptr(), n, build.dtype_code(src), build.DTYPE_CODES[cd], bpl * r, c,
                int(bool(inclusive)), int(src.data_ptr() % 16 == 0), out.data_ptr(),
                build.stream_ptr(out),
            )
        build.check(err, "mma_scan")
        mma_scan.launches += 1
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
