"""The reductions behind ``reduce``, ``reduce_many`` and ``reduce_tree``.

Port of ``repro/kernels/mma_reduce``'s fused, hierarchical, parts and
segmented paths:

  mma_sum_fused  -- the striped single-launch full reduction (the
                    counterpart of ``mma_sum_pallas(mode="fused")``; kernel
                    ``fused_accumulate_kernel``): one array, prologue,
                    epilogue chain and NaN/Inf census, lanes of
                    blocks of m^2 tiles, folded by
                    ``combine_lane_partials``. CUDA: ``csrc/fused_reduce.cu``.
  mma_sum_parts  -- S separate arrays in one launch (the counterpart of
                    ``mma_sum_parts_pallas``; kernel
                    ``parts_accumulate_kernel``), each in its own dtype with
                    no packing copy, at f32, bf16 or f16 compute; the output
                    row is ``[S part totals][K chains of the cross-part
                    total][S non-finite counts][1 total count]`` (the last
                    two with ``census=True``), or ``[S sums][S sums of
                    squares]`` with "moments" parts. CUDA:
                    ``csrc/parts_reduce.cu``.
  mma_sum_segments
                 -- S segments of ONE flat buffer in one launch (the
                    counterpart of ``mma_sum_segments_pallas``; kernel
                    ``segmented_gather_kernel``), read in place through
                    the aligned-block cover, striped one tile at a time
                    over lanes folded in lane order. CUDA:
                    ``csrc/segmented_gather.cu``.
  mma_sum_fused(kahan=True)
                 -- the fused stream with a per-lane Kahan carry of every
                    tile's row sums (``fused_kahan_kernel``, K3), folded in
                    two levels by ``combine_lane_pairs_kahan``: each lane's
                    CTA, then the launch's last CTA over the lanes' pairs.
                    CUDA: ``csrc/fused_kahan.cu``.
  mma_moments_fused
                 -- (sum, sumsq) from one fused stream, two accumulators
                    (``fused_moments_kernel``, K2), each half folded by
                    ``combine_lane_partials``. CUDA: ``csrc/fused_reduce.cu``.
  tile_partials  -- one level of the paper's hierarchy (``reduce_tiles``;
                    kernel ``tile_partials_kernel``, K10): every m^2 tile
                    through two all-ones MMAs. ``mma_sum_hier`` /
                    ``mma_moments_hier`` relaunch it per level (eq. 13);
                    ``mma_sum_hier_blocks`` reduces many blocks in each
                    level's one launch. CUDA: ``csrc/tile_partials.cu``.

On CPU tensors each wrapper runs its plain version, which folds in the
kernel's order where f32 adds decide it (the lane folds, the Kahan carry,
the parts' tiles and parts, the gather's rows, flushes and lanes). No
wrapper records a gradient: called on an input that requires grad it
raises and names the entry point (``reduce``, ``reduce_many``) whose
Functions differentiate it.

The geometry of the striped kernels is ``core.cost_model.stripe_geometry``
(``lane_geometry``), so the grids launched are the ones the cost model
charges for.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core import precision as _precision
from repro_torch.core.mma_reduce import ReductionTrace
from repro_torch.kernels import build, common
from repro_torch.kernels.common import ELEMENTWISE_PROLOGUES

MXU = common.MXU
TILE = MXU * MXU
# Live parts one launch takes (the kernel's by-value table); past this the
# reduce backends fold host-side, as the reference's backends do.
PARTS_KERNEL_MAX = 128
MAX_CHAINS = 4        # csrc/parts_reduce.cu PR_MAX_CHAINS
MAX_CHAIN_STEPS = 4   # csrc/parts_reduce.cu PR_MAX_STEPS
FUSED_MAX_CHAIN_STEPS = 8  # csrc/fused_reduce.cu FR_MAX_STEPS
TILES_PER_BLOCK = 8   # the reference's default block depth
LANE_FOLD_THREADS = 256  # csrc/fused_reduce.cu FR_THREADS
_PROLOGUE_CODES = {"identity": 0, "square": 1, "abs": 2, "moments": 3}
_NATIVE = common.NATIVE_INGEST_DTYPES


# ------------------------- striped fused (K1, K2, K3) ---------------------------


def lane_geometry(n: int, num_lanes: int = 1, tiles_per_block: int = TILES_PER_BLOCK):
    """``(r, c, blocks_per_lane, padded_tiles)`` of a striped stream of
    ``n`` elements: ``core.cost_model.stripe_geometry`` over its m^2 tiles
    (block depth, effective lane count, blocks per lane, padded tiles)."""
    tiles = max(1, common.ceil_div(n, TILE))
    return cost_model.stripe_geometry(tiles, tiles_per_block, num_lanes)


def default_num_lanes(x: torch.Tensor) -> int:
    """Lanes of a full reduction when the plan leaves them open: 1 on the
    CPU (the reference's off-TPU default); on a GPU four CTAs per SM, so a
    large stream keeps every SM busy (``lane_geometry`` clamps to the block
    count)."""
    if x.device.type != "cuda":
        return 1
    return 4 * torch.cuda.get_device_properties(x.device).multi_processor_count


def combine_lane_partials(partials: torch.Tensor) -> torch.Tensor:
    """(C,) f32 lane partials -> f32 scalar, in the kernel's fixed fold
    shape: thread i of 256 sums lanes i, i + 256, ... in order; each warp of
    32 threads folds by the shuffle tree (offsets 16, 8, 4, 2, 1); the 8
    warp totals are added in order. f32 adds in a fixed order: the kernel
    and this function agree bitwise on the same partials."""
    c = partials.numel()
    k = max(1, common.ceil_div(c, LANE_FOLD_THREADS))
    v = torch.nn.functional.pad(partials.to(torch.float32).reshape(-1),
                                (0, k * LANE_FOLD_THREADS - c)).view(k, LANE_FOLD_THREADS)
    acc = torch.zeros((LANE_FOLD_THREADS,), dtype=torch.float32, device=partials.device)
    for j in range(k):
        acc = acc + v[j]
    w = acc.view(LANE_FOLD_THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[:, :off] + w[:, off:2 * off]
    total = torch.zeros((), dtype=torch.float32, device=partials.device)
    for i in range(w.shape[0]):
        total = total + w[i, 0]
    return total


def combine_lane_pair_partials(partials: torch.Tensor) -> tuple:
    """(C, 2) moments lane pairs -> the (sum, sumsq) scalars, each half
    folded by ``combine_lane_partials`` (the kernel's fold of each half)."""
    return combine_lane_partials(partials[:, 0]), combine_lane_partials(partials[:, 1])


def combine_lane_partials_kahan(partials: torch.Tensor) -> torch.Tensor:
    """(C, 2, m) per-lane (acc rows, comp rows) -> f32 scalar by ONE serial
    Kahan pass: lane 0's acc rows, then its negated comp rows (Kahan's
    corrected sum is s - c), then lane 1's, ... (the reference's order,
    ``ops.py:85-96``). The kernel's last CTA runs the same pass."""
    acc, comp = partials[:, 0], partials[:, 1]
    v = torch.stack([acc, -comp], dim=1).reshape(-1)
    return _precision.kahan_sum(v, dtype=torch.float32)


def combine_lane_pairs_kahan(partials: torch.Tensor) -> torch.Tensor:
    """(C, 2, m) per-lane (acc rows, comp rows) -> f32 scalar, in K3's two
    levels: (1) for every lane at once, one serial Kahan pass over its acc
    rows 0..m-1, then its negated comp rows, gives the lane's pair (s_c,
    c_c); (2) one serial Kahan pass over s_0, -c_0, s_1, -c_1, ... in lane
    order gives the total (that pass's sum, as ``core.precision.kahan_sum``
    returns). Each lane enters pass (1) with the values and in the order it
    enters ``combine_lane_partials_kahan``'s single pass; the order across
    lanes differs. f32 operations in a fixed order: the kernel and this
    function agree bitwise on the same partials."""
    acc, comp = partials[:, 0].to(torch.float32), partials[:, 1].to(torch.float32)
    v = torch.cat([acc, -comp], dim=1)  # (C, 2m): each lane's pass, in order
    s = torch.zeros((v.shape[0],), dtype=torch.float32, device=v.device)
    c = torch.zeros_like(s)
    for i in range(v.shape[1]):
        y = v[:, i] - c
        t = s + y
        c = (t - s) - y
        s = t
    return _precision.kahan_sum(torch.stack([s, -c], dim=1).reshape(-1), dtype=torch.float32)


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """f32 values rounded to the compute dtype, kept in f32."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).to(torch.float32)


def _map(flat: torch.Tensor, prologue: str, compute_dtype) -> torch.Tensor:
    """The prologue on compute-cast f32 values, at the compute dtype."""
    if prologue == "square":
        return _round(flat * flat, compute_dtype)
    if prologue == "abs":
        return torch.abs(flat)
    return flat


def _striped(flat: torch.Tensor, num_lanes: int, tiles_per_block: int) -> torch.Tensor:
    """The zero-padded stream as (blocks_per_lane, lanes, r * m^2): ``[j,
    c]`` is block j * C + c, the block lane c streams at its step j."""
    r, c, bpl, tpad = lane_geometry(flat.numel(), num_lanes, tiles_per_block)
    padded = torch.nn.functional.pad(flat, (0, tpad * TILE - flat.numel()))
    return padded.view(bpl, c, r * TILE)


def mma_sum_fused_plain(x: torch.Tensor, compute_dtype=torch.bfloat16, prologue="identity",
                        epilogue=(), census: bool = False, num_lanes: int = 1,
                        tiles_per_block: int = TILES_PER_BLOCK):
    """Plain PyTorch version of the fused kernel: every element cast to the
    compute dtype, counted if non-finite, mapped by the prologue at the
    compute dtype; lane c sums blocks c, c + C, ... in f32; the lanes fold
    by ``combine_lane_partials``; the chain maps the total. Returns the
    total, or ``(total, count)`` with ``census``."""
    chain = common.normalize_epilogue(epilogue)
    flat = _round(x.reshape(-1).to(torch.float32), compute_dtype)
    count = torch.sum(~torch.isfinite(flat)).to(torch.float32)
    blocks = _striped(_map(flat, prologue, compute_dtype), num_lanes, tiles_per_block)
    total = common.apply_epilogue(combine_lane_partials(torch.sum(blocks, dim=(0, 2))), chain)
    return (total, count) if census else total


def mma_sum_kahan_plain(x: torch.Tensor, compute_dtype=torch.bfloat16, prologue="identity",
                        epilogue=(), num_lanes: int = 1, tiles_per_block: int = TILES_PER_BLOCK):
    """Plain PyTorch version of the Kahan kernel: the fused kernel's cast,
    prologue and striping; each tile's 128 row sums (f32, from zero) are
    two-summed into the lane's (acc, comp) rows in the lane's tile order
    (padded zero tiles included, as the reference's grid runs them); the
    lanes fold in two levels by ``combine_lane_pairs_kahan`` -- one Kahan
    pass per lane over its acc rows then its negated comp rows, then one
    over the lanes' pairs (s_0, -c_0, s_1, -c_1, ...) -- and the chain maps
    the total. The reference folds all lanes' rows in one serial pass
    (``combine_lane_partials_kahan``); with one lane the two orders differ
    only in the last step, which adds the lane's -c_0."""
    chain = common.normalize_epilogue(epilogue)
    flat = _map(_round(x.reshape(-1).to(torch.float32), compute_dtype), prologue, compute_dtype)
    blocks = _striped(flat, num_lanes, tiles_per_block)
    bpl, c, _ = blocks.shape
    rows = torch.sum(blocks.view(bpl, c, -1, MXU, MXU), dim=-1)  # (bpl, c, r, m)
    r = rows.shape[2]
    acc = torch.zeros((c, MXU), dtype=torch.float32, device=flat.device)
    comp = torch.zeros_like(acc)
    for j in range(bpl):
        for t in range(r):
            y = rows[j, :, t] - comp
            s = acc + y
            comp = (s - acc) - y
            acc = s
    total = combine_lane_pairs_kahan(torch.stack([acc, comp], dim=1))
    return common.apply_epilogue(total, chain)


def mma_moments_fused_plain(x: torch.Tensor, compute_dtype=torch.bfloat16, num_lanes: int = 1,
                            tiles_per_block: int = TILES_PER_BLOCK) -> tuple:
    """Plain PyTorch version of the moments kernel: the compute-cast
    elements and their squares taken at the compute dtype, each summed per
    lane in f32 and folded by ``combine_lane_pair_partials``."""
    flat = _round(x.reshape(-1).to(torch.float32), compute_dtype)
    sq = _round(flat * flat, compute_dtype)
    lanes = torch.stack([
        torch.sum(_striped(v, num_lanes, tiles_per_block), dim=(0, 2)) for v in (flat, sq)
    ], dim=1)
    return combine_lane_pair_partials(lanes)


def fused_trace(n: int, tiles_per_block: int = TILES_PER_BLOCK, num_lanes: int = 1, *,
                itemsize: int = 4, kahan: bool = False, dual: bool = False,
                epilogue: bool = False, census: bool = False,
                fallback: str = "") -> ReductionTrace:
    """The reference's per-lane / combine MMA count and modeled bytes of one
    fused pass, at the geometry the kernel launches (``lane_geometry``).
    ``dual``: the moments pair (two MMAs per tile, a doubled combine);
    ``epilogue``: the single-lane in-kernel finish; ``census``: the NaN/Inf
    count (the moments pair's output shape). The modeled partials are the
    reference's (m, m) lane accumulators; the port's kernels write less (a
    float or two per lane, 2 x 128 rows under the Kahan carry)."""
    _, c, _, tpad = lane_geometry(n, num_lanes, tiles_per_block)
    d = 2 if (dual or census) else 1
    lane, combine = d * (tpad // c), d * (c + 1)
    if census and epilogue:
        hbm = cost_model.fused_hbm_bytes(n, itemsize, num_cores=num_lanes,
                                         tiles_per_block=tiles_per_block, kahan=kahan,
                                         epilogue=True)
        hbm = cost_model.HbmTraffic(kernel_read=hbm.kernel_read, kernel_write=2 * hbm.kernel_write)
    else:
        hbm = cost_model.fused_hbm_bytes(n, itemsize, num_cores=num_lanes,
                                         tiles_per_block=tiles_per_block, kahan=kahan,
                                         dual=dual or census, epilogue=epilogue)
    return ReductionTrace(n=n, m=MXU, levels=1, mma_ops=d * tpad + combine, num_cores=c,
                          lane_mma_ops=lane, combine_mma_ops=combine, hbm_bytes=hbm.total,
                          fallback=fallback, census=census)


def _encode_chain(chain: tuple):
    enc = common.encode_epilogue(chain)
    if len(enc) > FUSED_MAX_CHAIN_STEPS:
        raise ValueError(f"a chain takes at most {FUSED_MAX_CHAIN_STEPS} steps; got {chain!r}")
    return (len(enc), np.array([op for op, _, _ in enc] or [0], dtype=np.int32),
            np.array([a for _, a, _ in enc] or [0.0], dtype=np.float32),
            np.array([b for _, _, b in enc] or [0.0], dtype=np.float32))


def _ingest(x: torch.Tensor):
    """Flat view of x in a dtype the kernels read (f32, bf16, f16), and the
    staging taken: other dtypes are cast to f32 first (one copy, the
    reference's ``_ingest``)."""
    flat = x.reshape(-1)
    if flat.dtype in _NATIVE:
        return flat, ""
    return flat.to(torch.float32), "ingest_f32"


def _lane_scratch(lanes: int, dev):
    """The fused kernels' lane partials: ``lanes`` f32 sums, then ``lanes``
    int32 counts (f32 sums of squares for the moments pair), each CTA
    writing its own; None for one lane, whose CTA writes the total itself
    (the kernel then takes a null pointer)."""
    if lanes == 1:
        return None
    return torch.empty((2 * lanes,), dtype=torch.int32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fused_io(flat, out, lane_words):
    """(read, write) bytes of one fused launch, from the tensors it was
    given: the buffer in, the output out, and the lanes' words (None for
    one lane of K1/K2) written by each lane's CTA and read back by the
    last."""
    lanes = 0 if lane_words is None else common.nbytes(lane_words)
    return common.nbytes(flat) + lanes, common.nbytes(out) + lanes


def _fused_plain_io(flat, num_lanes, tiles_per_block, outputs, kahan=False):
    """What ``_fused_io`` notes for the launch the plain version stands in
    for: the same tensors' bytes, by the launch's own lane geometry."""
    c = lane_geometry(flat.numel(), num_lanes, tiles_per_block)[1]
    lanes = 8 * c if (c > 1 or kahan) else 0
    return common.nbytes(flat) + lanes, 4 * outputs + lanes


def _launch_fused(flat, compute_dtype, prologue, chain, census, num_lanes, tiles_per_block):
    n = flat.numel()
    r, c, bpl, _ = lane_geometry(n, num_lanes, tiles_per_block)
    blocks = common.ceil_div(max(1, common.ceil_div(n, TILE)), r)
    steps, ops, p0, p1 = _encode_chain(chain)
    dev = flat.device
    out = torch.empty((2 if census else 1,), dtype=torch.float32, device=dev)
    scratch = _lane_scratch(c, dev)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().fr_sum(
            flat.data_ptr(), n, build.dtype_code(flat), build.DTYPE_CODES[compute_dtype],
            _PROLOGUE_CODES[prologue], int(bool(census)), r * TILE, blocks, c,
            int(flat.data_ptr() % 16 == 0), steps, ops.ctypes.data, p0.ctypes.data,
            p1.ctypes.data, out.data_ptr(), _ptr(scratch),
            common.fold_tickets("fused", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_sum_fused")
    common.record_io(mma_sum_fused, lambda: _fused_io(flat, out, scratch))
    return out


def _launch_kahan(flat, compute_dtype, prologue, chain, num_lanes, tiles_per_block):
    n = flat.numel()
    r, c, bpl, _ = lane_geometry(n, num_lanes, tiles_per_block)
    blocks = common.ceil_div(max(1, common.ceil_div(n, TILE)), r)
    steps, ops, p0, p1 = _encode_chain(chain)
    dev = flat.device
    out = torch.empty((1,), dtype=torch.float32, device=dev)
    lane_part = torch.empty((c, 2), dtype=torch.float32, device=dev)  # each lane's (s_c, c_c)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().fk_sum(
            flat.data_ptr(), n, build.dtype_code(flat), build.DTYPE_CODES[compute_dtype],
            _PROLOGUE_CODES[prologue], r, blocks, bpl, c, int(flat.data_ptr() % 16 == 0), steps,
            ops.ctypes.data, p0.ctypes.data, p1.ctypes.data, out.data_ptr(),
            lane_part.data_ptr(), common.fold_tickets("kahan", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_sum_fused(kahan=True)")
    common.record_io(mma_sum_kahan, lambda: _fused_io(flat, out, lane_part))
    return out


def _check_fused_args(compute_dtype, num_lanes, tiles_per_block):
    if compute_dtype not in _NATIVE:
        raise ValueError(f"compute dtype must be one of {_NATIVE}; got {compute_dtype}")
    if num_lanes < 1:
        raise ValueError(f"num_lanes must be >= 1; got {num_lanes}")
    if tiles_per_block < 1:
        raise ValueError(f"tiles_per_block must be >= 1; got {tiles_per_block}")


@common.counted("mma_sum_fused")
def mma_sum_fused(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    census: bool = False,
    num_lanes: int = 1,
    tiles_per_block: int = TILES_PER_BLOCK,
    kahan: bool = False,
    trace: list | None = None,
):
    """Sum all (prologue-mapped) elements of ``x`` in ONE kernel launch ->
    f32 scalar, or ``(total, count)`` with ``census`` (the NaN/Inf count of
    the compute-cast elements, before the prologue). ``epilogue`` maps the
    total in-launch. ``num_lanes`` stripes the blocks of ``tiles_per_block``
    m^2 tiles over that many CTAs (clamped to the block count); the lane
    fold is fixed, so the result is bitwise reproducible at a given lane
    count. bf16/f16 compute runs the ones-MMA on tensor cores; f32 compute
    sums on CUDA cores. Input other than f32/bf16/f16 is cast to f32 first
    (one staging copy, as the reference's ``_ingest``). ``trace``: a list
    that gets the pass's ``fused_trace``. CPU tensors: plain version.
    ``kahan=True`` is the compensated kernel, ``mma_sum_kahan`` (no
    census)."""
    if kahan:
        if census:
            raise ValueError("census does not compose with kahan=True (the compensation rows "
                             "take the second accumulator)")
        return mma_sum_kahan(x, compute_dtype=compute_dtype, prologue=prologue,
                             epilogue=epilogue, num_lanes=num_lanes,
                             tiles_per_block=tiles_per_block, trace=trace)
    common.refuse_grad("mma_sum_fused", x, entry="repro_torch.reduce.reduce(x, axis=None)")
    if prologue not in ELEMENTWISE_PROLOGUES:
        raise ValueError(f"prologue must be one of {ELEMENTWISE_PROLOGUES}; got {prologue!r}")
    _check_fused_args(compute_dtype, num_lanes, tiles_per_block)
    chain = common.normalize_epilogue(epilogue)
    if x.numel() == 0:  # nothing streamed: the chain of a zero total, count 0
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=MXU, levels=0, mma_ops=0))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        total = common.apply_epilogue(zero, chain)
        return (total, zero.clone()) if census else total
    flat, fallback = _ingest(x)
    if trace is not None:
        c = lane_geometry(flat.numel(), num_lanes, tiles_per_block)[1]
        trace.append(fused_trace(flat.numel(), tiles_per_block, num_lanes,
                                 itemsize=flat.element_size(), epilogue=bool(chain) and c == 1,
                                 census=census, fallback=fallback))
    if common.on_cpu(x):
        common.record_io(mma_sum_fused, lambda: _fused_plain_io(
            flat, num_lanes, tiles_per_block, 2 if census else 1), plain=True)
        return mma_sum_fused_plain(flat, compute_dtype, prologue, chain, census, num_lanes,
                                   tiles_per_block)
    out = _launch_fused(flat.contiguous(), compute_dtype, prologue, chain, census, num_lanes,
                        tiles_per_block)
    return (out[0], out[1]) if census else out[0]


@common.counted("mma_sum_kahan")
def mma_sum_kahan(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    num_lanes: int = 1,
    tiles_per_block: int = TILES_PER_BLOCK,
    trace: list | None = None,
) -> torch.Tensor:
    """``mma_sum_fused`` with the per-lane Kahan carry (the reference's
    ``kahan=True``), in ONE launch: each tile's 128 row sums are two-summed
    into the lane's (acc, comp) rows, each lane's CTA folds its rows by one
    Kahan pass, and the last CTA folds the lanes' pairs by another
    (``combine_lane_pairs_kahan``) and maps the total by the chain.
    Composes with square and abs; no census (the compensation rows take the
    second accumulator). Repeat launches agree bitwise. CPU tensors: plain
    version."""
    common.refuse_grad("mma_sum_kahan", x, entry="repro_torch.reduce.reduce(x, axis=None)")
    if prologue not in ELEMENTWISE_PROLOGUES:
        raise ValueError(
            f"prologue must be one of {ELEMENTWISE_PROLOGUES}; got {prologue!r} (the moments "
            "pair needs its own accumulators and does not compose with the Kahan carry)")
    _check_fused_args(compute_dtype, num_lanes, tiles_per_block)
    chain = common.normalize_epilogue(epilogue)
    if x.numel() == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=MXU, levels=0, mma_ops=0))
        return common.apply_epilogue(torch.zeros((), dtype=torch.float32, device=x.device), chain)
    flat, fallback = _ingest(x)
    if trace is not None:
        trace.append(fused_trace(flat.numel(), tiles_per_block, num_lanes,
                                 itemsize=flat.element_size(), kahan=True, fallback=fallback))
    if common.on_cpu(x):
        common.record_io(mma_sum_kahan, lambda: _fused_plain_io(
            flat, num_lanes, tiles_per_block, 1, kahan=True), plain=True)
        return mma_sum_kahan_plain(flat, compute_dtype, prologue, chain, num_lanes,
                                   tiles_per_block)
    out = _launch_kahan(flat.contiguous(), compute_dtype, prologue, chain, num_lanes,
                        tiles_per_block)
    return out[0]


@common.counted("mma_moments_fused")
def mma_moments_fused(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    num_lanes: int = 1,
    tiles_per_block: int = TILES_PER_BLOCK,
    trace: list | None = None,
) -> tuple:
    """(sum, sum of squares) of every element of ``x`` from ONE launch over
    the raw buffer: two accumulators, X @ 1 on the compute-cast elements and
    X^2 @ 1 on their squares taken at the compute dtype (the reference's
    dual accumulator, ``fused_moments_kernel``), each half folded by the
    lane fold. No census and no epilogue, as in the reference. CPU
    tensors: plain version."""
    common.refuse_grad("mma_moments_fused", x,
                       entry="repro_torch.reduce.reduce(x, kind='moments')")
    _check_fused_args(compute_dtype, num_lanes, tiles_per_block)
    if x.numel() == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=MXU, levels=0, mma_ops=0))
        z = torch.zeros((), dtype=torch.float32, device=x.device)
        return z, z.clone()
    flat, fallback = _ingest(x)
    if trace is not None:
        trace.append(fused_trace(flat.numel(), tiles_per_block, num_lanes,
                                 itemsize=flat.element_size(), dual=True, fallback=fallback))
    if common.on_cpu(x):
        common.record_io(mma_moments_fused,
                         lambda: _fused_plain_io(flat, num_lanes, tiles_per_block, 2), plain=True)
        return mma_moments_fused_plain(flat, compute_dtype, num_lanes, tiles_per_block)
    flat = flat.contiguous()
    n = flat.numel()
    r, c, _, _ = lane_geometry(n, num_lanes, tiles_per_block)
    blocks = common.ceil_div(max(1, common.ceil_div(n, TILE)), r)
    dev = flat.device
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    scratch = _lane_scratch(c, dev)  # sums, then squares
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().fr_moments(
            flat.data_ptr(), n, build.dtype_code(flat), build.DTYPE_CODES[compute_dtype],
            r * TILE, blocks, c, int(flat.data_ptr() % 16 == 0), out.data_ptr(),
            _ptr(scratch), common.fold_tickets("moments", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_moments_fused")
    common.record_io(mma_moments_fused, lambda: _fused_io(flat, out, scratch))
    return out[0], out[1]


# --------------------------- the paper's level (K10) ---------------------------


def tile_geometry(n: int, tiles_per_block: int = TILES_PER_BLOCK):
    """``(t, r, blocks, tpad)`` of one level over n values: m^2 tiles, tiles
    per CTA, CTAs, and the padded tile count the launch writes."""
    t = max(1, common.ceil_div(n, TILE))
    r = max(1, min(tiles_per_block, t))
    blocks = common.ceil_div(t, r)
    return t, r, blocks, blocks * r


def _two_mma_plain(tiles: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(T, m, m) compute-cast values -> (T,) f32: D = X @ 1 (row sums in
    f32), D rounded to the compute dtype, then 1 @ D."""
    return torch.sum(_round(torch.sum(tiles, dim=-1), compute_dtype), dim=-1)


def tile_partials_plain(flat: torch.Tensor, compute_dtype=torch.bfloat16, prologue="identity",
                        epilogue=(), tiles_per_block: int = TILES_PER_BLOCK) -> torch.Tensor:
    """Plain PyTorch version of one level: the values cast to the compute
    dtype (f32 partials too, as ``_load_tiles`` does), zero-padded to the
    launch's tiles, mapped by the prologue at the compute dtype, each tile
    through ``_two_mma_plain``; the chain maps the partials. Returns the
    (tpad,) row the launch writes, or (tpad, 2) for moments."""
    chain = common.normalize_epilogue(epilogue)
    _, _, _, tpad = tile_geometry(flat.numel(), tiles_per_block)
    v = _round(flat.reshape(-1).to(torch.float32), compute_dtype)
    tiles = torch.nn.functional.pad(v, (0, tpad * TILE - v.numel())).view(tpad, MXU, MXU)
    if prologue == "moments":
        return torch.stack([_two_mma_plain(tiles, compute_dtype),
                            _two_mma_plain(_round(tiles * tiles, compute_dtype), compute_dtype)],
                           dim=-1)
    return common.apply_epilogue(_two_mma_plain(_map(tiles, prologue, compute_dtype),
                                                compute_dtype), chain)


@common.counted("tile_partials")
def tile_partials(
    flat: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    tiles_per_block: int = TILES_PER_BLOCK,
    io: list | None = None,
) -> torch.Tensor:
    """One level of the hierarchy in ONE launch: (n,) values -> (t,) tile
    partials (t = ceil(n / m^2)), or (t, 2) under the moments prologue (the
    tile sums of x and of x^2 at the compute dtype, from one pass). Level 0
    reads the caller's buffer in its own dtype; a level above reads the f32
    partials, possibly one column of a moments pair (a stride-2 view, read
    in place). ``epilogue`` only on a final level (t == 1). ``io``: a list
    that gets the bytes the launch reads and writes (its operand's and its
    padded output's), to hold against ``cost_model.hier_hbm_bytes``. CPU
    tensors: plain version."""
    common.refuse_grad("tile_partials", flat, entry="repro_torch.reduce.reduce(x, axis=None)")
    common.check_prologue(prologue)
    if flat.ndim != 1 or flat.numel() == 0:
        raise ValueError(f"tile_partials takes a non-empty 1-D operand; got {tuple(flat.shape)}")
    if compute_dtype not in _NATIVE:
        raise ValueError(f"compute dtype must be one of {_NATIVE}; got {compute_dtype}")
    if tiles_per_block < 1:
        raise ValueError(f"tiles_per_block must be >= 1; got {tiles_per_block}")
    chain = common.normalize_epilogue(epilogue)
    n = flat.numel()
    t, r, blocks, tpad = tile_geometry(n, tiles_per_block)
    if chain and (t != 1 or prologue == "moments"):
        raise ValueError(
            "tile_partials epilogue requires a final single-tile level (t == 1, non-moments); "
            f"got t={t}, prologue={prologue!r}")
    if flat.dtype not in _NATIVE:
        raise TypeError(f"tile_partials reads float32, bfloat16 or float16; got {flat.dtype}")
    cols = 2 if prologue == "moments" else 1
    read, write = n * flat.element_size(), tpad * cols * 4
    if io is not None:
        io.append(read + write)
    if common.on_cpu(flat):
        common.record_io(tile_partials, (read, write), plain=True)
        out = tile_partials_plain(flat, compute_dtype, prologue, chain, tiles_per_block)
        return out[:t]
    stride = flat.stride(0)
    if stride != 1 and flat.dtype != torch.float32:
        flat, stride = flat.contiguous(), 1
    steps, ops, p0, p1 = _encode_chain(chain)
    dev = flat.device
    out = torch.empty((tpad, 2) if cols == 2 else (tpad,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().tp_level(
            flat.data_ptr(), n, stride, build.dtype_code(flat), build.DTYPE_CODES[compute_dtype],
            _PROLOGUE_CODES[prologue], r, blocks, int(flat.data_ptr() % 16 == 0 and stride == 1),
            steps, ops.ctypes.data, p0.ctypes.data, p1.ctypes.data, out.data_ptr(),
            build.stream_ptr(out),
        )
    build.check(err, "tile_partials")
    common.record_io(tile_partials, (read, write))
    return out[:t]


def mma_sum_hier(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    tiles_per_block: int = TILES_PER_BLOCK,
    trace: list | None = None,
) -> torch.Tensor:
    """The paper's hierarchy (eq. 13) on the kernel: one ``tile_partials``
    launch per level, each on the f32 partials the previous one wrote,
    until one value is left -- ``cost_model.levels(n, m)`` launches. Level 0
    reads x in its own dtype and applies the prologue; the epilogue chain
    maps the total inside the final launch. ``trace``: a list that gets a
    ``ReductionTrace`` (levels, MMAs, the modeled ``hier_hbm_bytes`` and the
    bytes measured at the launches)."""
    common.check_prologue(prologue)
    if prologue == "moments":
        raise ValueError("the moments pair has its own entry point, mma_moments_hier")
    chain = common.normalize_epilogue(epilogue)
    if x.numel() == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=MXU, levels=0, mma_ops=0))
        return common.apply_epilogue(torch.zeros((), dtype=torch.float32, device=x.device), chain)
    flat, fallback = _ingest(x)
    n0 = flat.numel()
    hbm = cost_model.hier_hbm_bytes(n0, flat.element_size(), m=MXU,
                                    tiles_per_block=tiles_per_block)
    levels = mma_ops = 0
    io: list = []
    level_prologue, chain_applied = prologue, not chain
    while flat.numel() > 1:
        t = common.ceil_div(flat.numel(), TILE)
        flat = tile_partials(flat, compute_dtype=compute_dtype, prologue=level_prologue,
                             epilogue=chain if t == 1 else (), tiles_per_block=tiles_per_block,
                             io=io)
        chain_applied |= t == 1
        level_prologue = "identity"  # upper levels run on mapped partials
        levels += 1
        mma_ops += 2 * t
    out = flat.reshape(()).to(torch.float32)
    if level_prologue != "identity":
        # one element: no level ran, so the map applies here, at the compute
        # dtype, as a level-0 launch would
        out = _map(_round(out, compute_dtype), level_prologue, compute_dtype)
    if not chain_applied:
        out = common.apply_epilogue(out, chain)
    if trace is not None:
        trace.append(ReductionTrace(n=n0, m=MXU, levels=levels, mma_ops=mma_ops,
                                    hbm_bytes=hbm.total, fallback=fallback,
                                    launch_io_bytes=sum(io)))
    return out


def mma_moments_hier(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    tiles_per_block: int = TILES_PER_BLOCK,
    trace: list | None = None,
) -> tuple:
    """(sum, sum of squares) on the hierarchy: level 0 emits the (t, 2)
    pair from one pass over x; each column then climbs the identity
    hierarchy, read in place from the pair. ``trace`` as in
    ``mma_sum_hier`` (modeled by ``hier_moments_hbm_bytes``)."""
    if x.numel() == 0:
        if trace is not None:
            trace.append(ReductionTrace(n=0, m=MXU, levels=0, mma_ops=0))
        z = torch.zeros((), dtype=torch.float32, device=x.device)
        return z, z.clone()
    flat, fallback = _ingest(x)
    n0 = flat.numel()
    hbm = cost_model.hier_moments_hbm_bytes(n0, flat.element_size(), m=MXU,
                                            tiles_per_block=tiles_per_block)
    io: list = []
    t0 = common.ceil_div(n0, TILE)
    pair = tile_partials(flat, compute_dtype=compute_dtype, prologue="moments",
                         tiles_per_block=tiles_per_block, io=io)
    levels, mma_ops = 1, 4 * t0
    outs = []
    for col in (pair[:, 0], pair[:, 1]):
        v = col
        while v.numel() > 1:
            t = common.ceil_div(v.numel(), TILE)
            v = tile_partials(v, compute_dtype=compute_dtype, tiles_per_block=tiles_per_block,
                              io=io)
            levels += 1
            mma_ops += 2 * t
        outs.append(v.reshape(()).to(torch.float32))
    if trace is not None:
        trace.append(ReductionTrace(n=n0, m=MXU, levels=levels, mma_ops=mma_ops,
                                    hbm_bytes=hbm.total, fallback=fallback,
                                    launch_io_bytes=sum(io)))
    return outs[0], outs[1]


def mma_sum_hier_blocks(
    x: torch.Tensor,
    block: int,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    tiles_per_block: int = TILES_PER_BLOCK,
    trace: list | None = None,
) -> torch.Tensor:
    """Every block of ``block`` consecutive elements of x (the last one
    zero-padded), as f32, reduced by the hierarchy on its own -> (nblk,)
    block totals, with all blocks in each level's one launch: the blocked
    compensated combine's inner sums (``precision="kahan"`` on
    ``cuda_hier``). One staging copy lays the blocks out padded to whole
    tiles, so block b's values fill tiles of its own and each total is
    what a launch on that block alone gives; with ``block <= m^2`` that is
    ONE launch. ``trace`` gets the levels, MMAs and the modeled bytes
    (``cost_model.blocked_hier_hbm_bytes``, staging included)."""
    common.check_prologue(prologue)
    if prologue == "moments":
        raise ValueError("mma_sum_hier_blocks takes an elementwise prologue")
    if block < 1:
        raise ValueError(f"block must be >= 1; got {block}")
    flat = x.reshape(-1)
    n = flat.numel()
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    nblk = common.ceil_div(n, block)
    io: list = []
    levels = mma_ops = 0
    vals, size, pro = flat, block, prologue
    while True:
        kb = common.ceil_div(size, TILE)
        staged = torch.empty((nblk, kb * TILE), dtype=torch.float32, device=x.device)
        staged[:, size:].zero_()
        whole = vals.numel() // size  # blocks filled to the end
        staged[:whole, :size].copy_(vals[:whole * size].view(whole, size))
        if whole < nblk:
            tail = vals.numel() - whole * size
            staged[whole, :tail].copy_(vals[whole * size:])
            staged[whole, tail:size].zero_()
        vals = tile_partials(staged.view(-1), compute_dtype=compute_dtype, prologue=pro,
                             tiles_per_block=tiles_per_block, io=io)
        levels += 1
        mma_ops += 2 * nblk * kb
        pro = "identity"
        if kb == 1:
            break
        size = kb
    if trace is not None:
        hbm = cost_model.blocked_hier_hbm_bytes(n, flat.element_size(), block, m=MXU,
                                                tiles_per_block=tiles_per_block)
        trace.append(ReductionTrace(n=n, m=MXU, levels=levels, mma_ops=mma_ops,
                                    hbm_bytes=hbm.total, launch_io_bytes=sum(io)))
    return vals


# --------------------- the kernels' in-tile order (K4, K8) ---------------------


def tile_row_sums_plain(tiles: torch.Tensor) -> torch.Tensor:
    """(T, m^2) f32 values -> (T, m) f32 row sums in the order the gather
    and parts kernels take at f32 compute (``reduce_common.cuh``
    ``tile_row_sums``): thread t4 of a row's quad adds its 32 elements 8 t4 +
    32 u + i in (u, i) order, then the quad folds (s0 + s1) + (s2 + s3). At
    bf16/f16 compute the kernels take the same sums on tensor cores, whose
    f32 accumulation order is the hardware's."""
    v = tiles.reshape(-1, MXU, 4, 4, 8)  # (tile, row, u, t4, i)
    s = torch.zeros(v.shape[:2] + (4,), dtype=torch.float32, device=tiles.device)
    for u in range(4):
        for i in range(8):
            s = s + v[:, :, u, :, i]
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def fold_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """(K, m) f32 row values -> (K,) in the kernels' fold of one tile's rows
    (``csrc/segmented_gather.cu`` ``block_fold``): in warp w, the leader of
    quad g adds rows 16 w + g and 16 w + g + 8; a shuffle-down tree folds the
    warp's 32 lanes (non-leaders give 0); thread 0 adds the 8 warp totals in
    order, from 0."""
    r = rows.reshape(-1, 8, 2, 8)  # (k, warp, half, g)
    lanes = torch.zeros((r.shape[0], 8, 32), dtype=torch.float32, device=rows.device)
    lanes[:, :, 0::4] = r[:, :, 0] + r[:, :, 1]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
    total = torch.zeros((r.shape[0],), dtype=torch.float32, device=rows.device)
    for w in range(8):
        total = total + lanes[:, w, 0]
    return total


# ------------------------------ parts (K4) ------------------------------------


def parts_layout(sizes: Sequence[int], group: int) -> tuple:
    """Static tile schedule: one ``(seg, start, nblk, size)`` run per
    NON-EMPTY part, consecutive on the shared grid."""
    layout = []
    start = 0
    for s, size in enumerate(sizes):
        size = int(size)
        if size == 0:
            continue
        nblk = common.ceil_div(size, group)
        layout.append((s, start, nblk, size))
        start += nblk
    return tuple(layout)


def _empty_row(nseg, out_slots, slot_chain, total_chains, census, device) -> torch.Tensor:
    """Every part empty: the slot chain of zero totals, each total chain of
    a zero total, and (with census) zero counts -- nothing streamed, nothing
    non-finite (the reference's all-empty row)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    pieces = [common.apply_epilogue(torch.zeros((out_slots,), dtype=torch.float32,
                                                device=device), slot_chain)]
    if total_chains:
        pieces.append(torch.stack([common.apply_epilogue(zero, ch) for ch in total_chains]))
    if census:
        pieces.append(torch.zeros((nseg + 1,), dtype=torch.float32, device=device))
    return torch.cat(pieces)


def _part_tile_sums(flat: torch.Tensor, pro: str, compute_dtype):
    """One part's per-tile (sum, sum of squares or None, non-finite count)
    as the parts kernel takes them. f32 compute: the raw f32 values, each
    tile summed on its own (its CUDA-core order is not mirrored). bf16/f16:
    the values rounded to the compute dtype, counted, mapped there, and
    each tile's rows summed and folded in the kernels' order."""
    n = flat.numel()
    nblk = common.ceil_div(n, TILE)
    v = _round(flat, compute_dtype)
    cnt = int(torch.sum(~torch.isfinite(v)))
    tiles = torch.nn.functional.pad(v, (0, nblk * TILE - n)).view(nblk, TILE)
    squares = None
    if compute_dtype == torch.float32:
        if pro == "moments":
            return torch.sum(tiles, dim=1), torch.sum(tiles * tiles, dim=1), cnt
        return torch.sum(common.apply_prologue(tiles, pro), dim=1), None, cnt
    if pro == "moments":
        squares = fold_rows_plain(tile_row_sums_plain(_round(tiles * tiles, compute_dtype)))
        mapped = tiles
    else:
        mapped = _map(tiles, pro, compute_dtype)
    return fold_rows_plain(tile_row_sums_plain(mapped)), squares, cnt


def mma_sum_parts_plain(parts, prologues, total_chains, census, compute_dtype=torch.float32,
                        slot_epilogue=()) -> torch.Tensor:
    """Plain PyTorch version of the parts kernel: per tile a sum of the
    prologue-mapped values (``_part_tile_sums``) and a count of the
    non-finite compute-cast ones; per part a sequential fold of its tiles,
    mapped by the slot chain; then a sequential fold of the raw part totals
    for the chains. A "moments" part also folds its tiles' sums of squares
    (at the compute dtype) into slot S + s. Empty parts keep 0."""
    nseg = len(parts)
    dev = parts[0].device
    dual = "moments" in prologues
    out_slots = 2 * nseg if dual else nseg
    n_chains = len(total_chains)
    out = torch.zeros((out_slots + n_chains + ((nseg + 1) if census else 0),),
                      dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    total_cnt = 0
    for s, (part, pro) in enumerate(zip(parts, prologues)):
        flat = part.reshape(-1).to(torch.float32)
        if flat.numel() == 0:
            continue
        sums, squares, cnt = _part_tile_sums(flat, pro, compute_dtype)
        ps = torch.zeros((), dtype=torch.float32, device=dev)
        ps2 = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(sums.numel()):
            ps = ps + sums[t]
            if squares is not None:
                ps2 = ps2 + squares[t]
        out[s] = common.apply_epilogue(ps, slot_epilogue)
        if squares is not None:
            out[nseg + s] = ps2
        total = total + ps
        if census:
            out[out_slots + n_chains + s] = cnt
            total_cnt += cnt
    for k, ch in enumerate(total_chains):
        out[out_slots + k] = common.apply_epilogue(total, ch)
    if census:
        out[-1] = total_cnt
    return out


def _encode_chains(chains: tuple):
    """K chains -> (lens, ops, p0, p1) arrays of [K][MAX_CHAIN_STEPS]."""
    k = max(len(chains), 1)
    lens = np.zeros((k,), dtype=np.int32)
    ops = np.zeros((k, MAX_CHAIN_STEPS), dtype=np.int32)
    p0 = np.zeros((k, MAX_CHAIN_STEPS), dtype=np.float32)
    p1 = np.zeros((k, MAX_CHAIN_STEPS), dtype=np.float32)
    for i, ch in enumerate(chains):
        enc = common.encode_epilogue(ch)
        if len(enc) > MAX_CHAIN_STEPS:
            raise ValueError(f"a chain takes at most {MAX_CHAIN_STEPS} steps; got {ch!r}")
        lens[i] = len(enc)
        for j, (op, a, b) in enumerate(enc):
            ops[i, j], p0[i, j], p1[i, j] = op, a, b
    return lens, ops, p0, p1


def parts_scratch_words(n_tiles: int) -> int:
    """4-byte words of the parts kernel's scratch (``csrc/parts_reduce.cu``):
    a sum, a sum of squares and a non-finite count per tile, then, from an
    even word, a sum and a sum of squares (f32) and a count (int64) per
    part. Every CTA writes its own words before any are read, so the
    scratch needs no clearing (and no second launch)."""
    return (3 * n_tiles + 1) // 2 * 2 + 4 * PARTS_KERNEL_MAX


def _launch(parts, layout, prologues, compute_dtype, slot_chain, total_chains, census,
            dual) -> torch.Tensor:
    nseg = len(parts)
    dev = parts[0].device
    n_live = len(layout)
    live = [parts[s].contiguous() for (s, _, _, _) in layout]
    n_tiles = layout[-1][1] + layout[-1][2]
    ptrs = np.array([p.data_ptr() for p in live], dtype=np.uint64)
    sizes = np.array([size for (_, _, _, size) in layout], dtype=np.int64)
    starts = np.array([start for (_, start, _, _) in layout] + [n_tiles], dtype=np.int32)
    segs = np.array([s for (s, _, _, _) in layout], dtype=np.int32)
    dtypes = np.array([build.dtype_code(p) for p in live], dtype=np.int32)
    pros = np.array([_PROLOGUE_CODES[prologues[s]] for (s, _, _, _) in layout], dtype=np.int32)
    k = len(total_chains)
    lens, ops, p0, p1 = _encode_chains(total_chains)
    s_len, s_ops, s_p0, s_p1 = _encode_chains((slot_chain,))
    out_slots = 2 * nseg if dual else nseg
    out = torch.empty((out_slots + k + ((nseg + 1) if census else 0),),
                      dtype=torch.float32, device=dev)
    scratch = torch.empty((parts_scratch_words(n_tiles),), dtype=torch.int32, device=dev)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().pr_parts(
            ptrs.ctypes.data, sizes.ctypes.data, starts.ctypes.data, segs.ctypes.data,
            dtypes.ctypes.data, pros.ctypes.data, n_live, nseg,
            build.DTYPE_CODES[compute_dtype], int(dual), int(s_len[0]), s_ops.ctypes.data,
            s_p0.ctypes.data, s_p1.ctypes.data, lens.ctypes.data, ops.ctypes.data,
            p0.ctypes.data, p1.ctypes.data, k, int(bool(census)), out.data_ptr(),
            scratch.data_ptr(),
            common.fold_tickets("parts", dev, stream, count=PARTS_KERNEL_MAX + 1).data_ptr(),
            stream,
        )
    build.check(err, "mma_sum_parts")
    return out


@common.counted("mma_sum_parts")
def mma_sum_parts(
    parts: Sequence[torch.Tensor],
    *,
    compute_dtype=torch.float32,
    prologue="identity",
    slot_epilogue=(),
    total_chains=(),
    census: bool = False,
) -> torch.Tensor:
    """Sum S separate (prologue-mapped) arrays in ONE kernel launch with no
    packing copy -> ``(S + K [+ S + 1],)`` f32 row (see the module doc).

    ``prologue`` is a name or one name per part ("identity", "square",
    "abs", "moments"); a "moments" part also sums its squares (at the
    compute dtype) into slot S + s of the widened ``(2 S,)`` row, and other
    parts leave that slot 0. ``slot_epilogue`` maps every flushed per-part
    total in the launch (empty parts keep 0 while any part is live, as in
    the reference); ``total_chains`` is a tuple of K normalized chains of
    the RAW cross-part total. Neither chains nor census compose with a
    "moments" part. ``compute_dtype``: f32 sums on the CUDA cores; bf16 and
    f16 round each element there and take the row sums as ones-MMAs on the
    tensor cores. Parts other than f32/bf16/f16 are cast to f32 first (one
    staging copy each). CPU tensors run the plain version; CUDA tensors
    launch the kernel. Not differentiable: an input that requires grad
    raises (``reduce_many`` and ``reduce_tree`` differentiate it)."""
    parts = tuple(parts)
    common.refuse_grad("mma_sum_parts", *parts, entry="repro_torch.reduce.reduce_many")
    nseg = len(parts)
    slot_chain = common.normalize_epilogue(slot_epilogue)
    total_chains = tuple(common.normalize_epilogue(c) for c in total_chains)
    if compute_dtype not in _NATIVE:
        raise ValueError(f"compute dtype must be one of {_NATIVE}; got {compute_dtype}")
    if nseg == 0:
        if total_chains:
            raise ValueError("total_chains need at least one part")
        if census:
            raise ValueError("census needs at least one part")
        return torch.zeros((0,), dtype=torch.float32)
    pros = common.normalize_part_prologues(prologue, nseg)
    dual = "moments" in pros
    if dual and (slot_chain or total_chains or census):
        raise ValueError(
            "parts epilogues/census do not compose with a 'moments' part (its flush writes "
            "two coupled slots); run the moments leaf as separate 'identity'/'square' parts")
    if len(total_chains) > MAX_CHAINS:
        raise ValueError(f"at most {MAX_CHAINS} total chains; got {len(total_chains)}")
    if len(common.encode_epilogue(slot_chain)) > MAX_CHAIN_STEPS:
        raise ValueError(f"a chain takes at most {MAX_CHAIN_STEPS} steps; got {slot_chain!r}")
    flats = [_ingest(p)[0] for p in parts]
    layout = parts_layout([f.numel() for f in flats], TILE)
    out_slots = 2 * nseg if dual else nseg
    if not layout:
        return _empty_row(nseg, out_slots, slot_chain, total_chains, census, parts[0].device)
    read = common.nbytes(*flats)
    if common.on_cpu(*parts):
        out = mma_sum_parts_plain(flats, pros, total_chains, census, compute_dtype, slot_chain)
        common.record_io(mma_sum_parts, (read, 4 * out.numel()), plain=True)
        return out
    if len(layout) > PARTS_KERNEL_MAX:
        raise ValueError(
            f"{len(layout)} live parts exceed PARTS_KERNEL_MAX={PARTS_KERNEL_MAX}; "
            "the reduce backends pack such trees and take one sum_segments pass"
        )
    out = _launch(flats, layout, pros, compute_dtype, slot_chain, total_chains, census, dual)
    common.record_io(mma_sum_parts, (read, 4 * out.numel()))
    return out


# --------------------------- segmented gather (K8) -----------------------------


def segment_cover_layout(offsets: Sequence[int], group: int):
    """Aligned-block cover of a segmented flat buffer (the reference's):
    segment s spans ``[offsets[s], offsets[s + 1])``; its tiles are the
    ``group``-aligned blocks that overlap it, each with the in-block window
    ``[lo, hi)`` of s's elements. A non-aligned boundary puts its block in
    both neighbours' covers. Returns ``(tile_counts, src_blk, seg_of, lo_in,
    hi_in)``: per-segment cover sizes (0 for empty segments) and the four
    int32 per-tile maps."""
    offs = np.asarray(offsets, np.int64)
    a, b = offs[:-1], offs[1:]
    live = b > a
    blk0 = a // group
    counts = np.where(live, -(-b // group) - blk0, 0)
    seg = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    # each cover tile's block: its segment's first block plus its rank there
    first = np.cumsum(counts) - counts
    src = blk0[seg] + np.arange(seg.size, dtype=np.int64) - first[seg]
    lo = np.maximum(a[seg] - src * group, 0)
    hi = np.minimum(b[seg] - src * group, group)
    return (tuple(int(c) for c in counts),) + tuple(v.astype(np.int32)
                                                    for v in (src, seg, lo, hi))


def segment_tile_layout(offsets: Sequence[int], group: int):
    """Tile bookkeeping of a PACKED segmented stream (each segment
    zero-padded to whole tiles and concatenated): per-segment tile counts,
    the tile -> segment map and the serial flush map (1 on each non-empty
    segment's last tile)."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    tcounts = tuple(int(-(-s // group)) if s > 0 else 0 for s in sizes)
    total = sum(tcounts)
    seg_of = np.zeros((total,), np.int32)
    flush = np.zeros((total,), np.int32)
    pos = 0
    for s, tc in enumerate(tcounts):
        if tc == 0:
            continue
        seg_of[pos:pos + tc] = s
        flush[pos + tc - 1] = 1
        pos += tc
    return tcounts, seg_of, flush


def lane_flush_map(seg_of, tiles_per_block: int, num_cores: int) -> np.ndarray:
    """Lane-aware flush flags of a striped segmented stream: lane ci of C
    streams blocks ci, ci + C, ... of ``tiles_per_block`` tiles, and flags
    position p iff p is the last tile of its segment within its own stripe.
    One lane gives the serial last-tile-of-segment map. (The reference's
    loop, as one vectorized pass: the next tile of p's stripe is p + 1 inside
    a block, else the first tile of the lane's next block.)"""
    seg_of = np.asarray(seg_of)
    t = int(seg_of.size)
    if t == 0:
        return np.zeros((0,), np.int32)
    r, c, _, _ = cost_model.stripe_geometry(t, tiles_per_block, num_cores)
    p = np.arange(t, dtype=np.int64)
    nxt = np.where(p % r < r - 1, p + 1, p + (c - 1) * r + 1)
    last = nxt >= t
    differs = seg_of[np.minimum(nxt, t - 1)] != seg_of
    return (last | differs).astype(np.int32)


def segmented_trace(n: int, flushes: int, tiles: int, num_cores: int, *, itemsize: int = 4,
                    fetched_elems: int | None = None, segments: int = 1, dual: bool = False,
                    census: bool = False, launch_io_bytes: int = 0) -> ReductionTrace:
    """The reference's MMA count and modeled bytes of one gather pass (flush
    MMAs are the combine; ``fetched_elems`` counts every element the cover
    reads; ``segments`` and ``flushes`` arrive widened for moments and
    census), with the bytes measured at the launch."""
    _, c, _, tpad = cost_model.stripe_geometry(tiles, 1, num_cores)
    d = 2 if (dual or census) else 1
    hbm = cost_model.segmented_hbm_bytes(fetched_elems if fetched_elems is not None else n,
                                         itemsize, segments=segments, tiles=tiles,
                                         num_cores=num_cores)
    return ReductionTrace(n=n, m=MXU, levels=1, mma_ops=d * tpad + flushes, num_cores=c,
                          lane_mma_ops=d * (tpad // c), combine_mma_ops=flushes,
                          hbm_bytes=hbm.total, census=census, launch_io_bytes=launch_io_bytes)


def _cover_fetched_elems(src_blk, flat_size: int, group: int) -> int:
    """Elements the gather reads: one block per cover tile, clipped to the
    buffer (n for aligned segments; a straddled block is read once per
    neighbour)."""
    src = np.asarray(src_blk, np.int64)
    return int(np.minimum(group, flat_size - src * group).sum())


def segment_lanes(seg_of, nseg: int, lanes: int) -> np.ndarray:
    """(C, S) bool: lane c streamed a tile of segment s (tile t of the
    cover is lane t mod C's)."""
    seg_of = np.asarray(seg_of, np.int64)
    touched = np.zeros((lanes, nseg), bool)
    touched[np.arange(seg_of.size) % lanes, seg_of] = True
    return touched


def combine_segment_partials(sub: torch.Tensor, touched=None) -> torch.Tensor:
    """(C, S) lane sub-partials -> (S,) per-segment totals, in lane order
    (f32): each segment's first lane's value, then the next lane's added,
    ... over the lanes that streamed a tile of it (``touched``, (C, S)
    bool; all lanes when None); a segment no lane streamed is 0. The
    kernel's last CTA folds in the same order, so the two agree bitwise on
    the same partials; with C = 1 this is the identity."""
    if touched is None:
        touched = np.ones(tuple(sub.shape), bool)
    touched = torch.as_tensor(touched, device=sub.device)
    out = torch.zeros(sub.shape[1], dtype=sub.dtype, device=sub.device)
    started = torch.zeros(sub.shape[1], dtype=torch.bool, device=sub.device)
    for c in range(sub.shape[0]):
        m = touched[c]
        out = torch.where(m & started, out + sub[c], torch.where(m, sub[c], out))
        started |= m
    return out


def _segments_all_empty(nseg, epilogue, census, dual, device) -> torch.Tensor:
    per = common.apply_epilogue(torch.zeros((nseg,), dtype=torch.float32, device=device),
                                epilogue)
    if census:  # nothing streamed: zero counts, no chain
        return torch.cat([per, torch.zeros((nseg,), dtype=torch.float32, device=device)])
    return torch.zeros((2 * nseg,), dtype=torch.float32, device=device) if dual else per


@functools.lru_cache(maxsize=64)
def _cover_maps(offsets: tuple, num_lanes: int):
    """The cover layout and the (5, tpad) int32 map array the gather kernel
    reads: rows src block, segment, lane-aware flush flag, lo, hi; padded to
    whole lanes with fully masked tiles (lo == hi == 0, no flush) whose
    segment is S, so the segment row stays sorted. Cached on the offsets
    (a packed layout is reduced again and again); callers must not write
    to the arrays."""
    tcounts, src, seg, lo, hi = segment_cover_layout(offsets, TILE)
    t = int(src.size)
    flush = lane_flush_map(seg, 1, num_lanes)
    _, c, tpl, tpad = cost_model.stripe_geometry(max(t, 1), 1, num_lanes)
    maps = np.zeros((5, tpad), np.int32)
    maps[1, t:] = len(offsets) - 1
    for row, a in enumerate((src, seg, flush, lo, hi)):
        maps[row, :t] = a
    maps.setflags(write=False)
    return tcounts, maps, t, c, tpl


@functools.lru_cache(maxsize=16)
def _device_maps(offsets: tuple, num_lanes: int, device: str) -> torch.Tensor:
    """``_cover_maps``' array on the card, uploaded once per layout."""
    return torch.from_numpy(_cover_maps(offsets, num_lanes)[1].copy()).to(device)


def mma_sum_segments_plain(flat: torch.Tensor, offsets: Sequence[int],
                           compute_dtype=torch.bfloat16, prologue: str = "identity",
                           epilogue=(), census: bool = False,
                           num_lanes: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: each cover tile's block,
    cast to the compute dtype and masked to its window ``[lo, hi)``, counted
    if non-finite, mapped by the prologue at the compute dtype, its rows
    summed (``tile_row_sums_plain``); lane c adds its tiles' rows in its
    stripe order and at each flush folds them (``fold_rows_plain``) into its
    (c, segment) slot; the lanes fold in order (``combine_segment_partials``)
    and the chain maps every sum slot, empty segments included. At f32
    compute this is the kernel's arithmetic, bitwise; at bf16/f16 the
    tensor cores sum each row in their own order."""
    chain = common.normalize_epilogue(epilogue)
    nseg = len(offsets) - 1
    dual = prologue == "moments"
    flat = flat.reshape(-1)
    dev = flat.device
    tcounts, maps, t, c, tpl = _cover_maps(tuple(int(o) for o in offsets), num_lanes)
    if t == 0:
        return _segments_all_empty(nseg, chain, census, dual, dev)
    out_slots = 2 * nseg if (dual or census) else nseg
    n = flat.numel()
    nblk = common.ceil_div(n, TILE)
    v = _round(flat.to(torch.float32), compute_dtype)
    blocks = torch.nn.functional.pad(v, (0, nblk * TILE - n)).view(nblk, TILE)
    m = torch.from_numpy(maps.astype(np.int64)).to(dev)
    src, seg, flush, lo, hi = m
    tiles = blocks[src]  # (tpad, m^2): padded tiles read block 0, fully masked
    lin = torch.arange(TILE, device=dev)
    window = (lin[None, :] >= lo[:, None]) & (lin[None, :] < hi[:, None])
    tiles = torch.where(window, tiles, torch.zeros((), device=dev))
    second = None
    if census:
        second = tile_row_sums_plain((~torch.isfinite(tiles)).to(torch.float32))
    if dual:
        first = tile_row_sums_plain(tiles)
        second = tile_row_sums_plain(_round(tiles * tiles, compute_dtype))
    else:
        first = tile_row_sums_plain(_map(tiles, prologue, compute_dtype))
    sub = torch.zeros((c, out_slots), dtype=torch.float32, device=dev)
    acc = torch.zeros((c, MXU), dtype=torch.float32, device=dev)
    acc2 = torch.zeros_like(acc)
    lanes = torch.arange(c, device=dev)
    first, seg_l, flush_l = (a.view(tpl, c, *a.shape[1:]) for a in (first, seg, flush))
    second = second.view(tpl, c, MXU) if second is not None else None
    for j in range(tpl):
        acc = acc + first[j]
        if second is not None:
            acc2 = acc2 + second[j]
        f = flush_l[j] != 0
        if not bool(f.any()):
            continue
        cols = seg_l[j][f]
        sub[lanes[f], cols] = fold_rows_plain(acc[f])
        acc[f] = 0.0
        if second is not None:
            sub[lanes[f], nseg + cols] = fold_rows_plain(acc2[f])
            acc2[f] = 0.0
    touched = segment_lanes(maps[1, :t], nseg, c)
    if out_slots > nseg:  # the second slot of a segment was streamed by the same lanes
        touched = np.concatenate([touched, touched], axis=1)
    out = combine_segment_partials(sub, touched)
    if chain:  # the sum slots; counts stay raw tallies
        out = torch.cat([common.apply_epilogue(out[:nseg], chain), out[nseg:]])
    return out


@common.counted("mma_sum_segments")
def mma_sum_segments(
    flat: torch.Tensor,
    offsets: Sequence[int],
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    census: bool = False,
    num_lanes: int = 1,
    trace: list | None = None,
) -> torch.Tensor:
    """Sum S segments ``flat[offsets[s]:offsets[s + 1]]`` of one flat buffer
    in ONE kernel launch, reading the buffer in place through the aligned
    block cover (``segment_cover_layout``; no slice-pad-concatenate copy).
    Returns (S,) f32, or (2 S,) with ``prologue="moments"`` (sums, then sums
    of squares at the compute dtype) or with ``census`` (sums, then each
    segment's non-finite count of its compute-cast values). The prologue
    (identity, square, abs) maps each masked value at the compute dtype.
    ``epilogue`` maps every sum slot -- empty segments give the chain of 0
    at any lane count -- but not with "moments"; counts stay raw.

    The cover is striped over ``num_lanes`` CTAs one tile at a time; each
    lane flushes one sub-partial per segment it visits (``lane_flush_map``),
    and the launch's last CTA folds the lanes in lane order
    (``combine_segment_partials``). Input other than f32/bf16/f16 is cast
    to f32 first. ``trace`` gets the pass's ``segmented_trace``, with the
    bytes handed to and written by the launch. CPU tensors: plain
    version."""
    common.refuse_grad("mma_sum_segments", flat, entry="repro_torch.reduce.reduce_many")
    common.check_prologue(prologue)
    if compute_dtype not in _NATIVE:
        raise ValueError(f"compute dtype must be one of {_NATIVE}; got {compute_dtype}")
    if num_lanes < 1:
        raise ValueError(f"num_lanes must be >= 1; got {num_lanes}")
    chain = common.normalize_epilogue(epilogue)
    dual = prologue == "moments"
    if chain and dual:
        raise ValueError("segment epilogues do not compose with prologue='moments' "
                         "(each flush writes two coupled slots)")
    if census and dual:
        raise ValueError("census does not compose with prologue='moments' (both claim the "
                         "second accumulator); run moments as separate segments")
    offsets = tuple(int(o) for o in offsets)
    nseg = len(offsets) - 1
    if nseg <= 0:
        return torch.zeros((0,), dtype=torch.float32, device=flat.device)
    src_flat, fallback = _ingest(flat)
    if offsets[0] < 0 or offsets[-1] > src_flat.numel() or any(
            b < a for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets must rise from 0 within the buffer of {src_flat.numel()}")
    tcounts, maps, t, c, tpl = _cover_maps(offsets, num_lanes)
    if t == 0:
        return _segments_all_empty(nseg, chain, census, dual, flat.device)
    out_slots = 2 * nseg if (dual or census) else nseg
    itemsize = src_flat.element_size()
    sub_bytes = c * out_slots * 4

    def fetched():
        return _cover_fetched_elems(maps[0, :t], src_flat.numel(), TILE)

    def launch_io():  # computed only for a trace or an open meter
        # the cover blocks and maps in, the lanes' sub-partials out and back
        # into the last CTA's fold, the result row out
        read = fetched() * itemsize + maps.nbytes + sub_bytes
        return read, sub_bytes + out_slots * 4

    if trace is not None:
        flushes = int(maps[2].sum())
        trace.append(dataclasses.replace(
            segmented_trace(src_flat.numel(), (2 if (dual or census) else 1) * flushes, t,
                            num_lanes, itemsize=itemsize, fetched_elems=fetched(),
                            segments=out_slots, dual=dual, census=census,
                            launch_io_bytes=launch_io()[0]),
            fallback=fallback))
    if common.on_cpu(flat):
        common.record_io(mma_sum_segments, launch_io, plain=True)
        return mma_sum_segments_plain(src_flat, offsets, compute_dtype, prologue, chain, census,
                                      num_lanes)
    x = src_flat.contiguous()
    dev = x.device
    steps, ops, p0, p1 = _encode_chain(chain)
    dmaps = _device_maps(offsets, num_lanes, str(dev))
    sub = torch.empty((c, out_slots), dtype=torch.float32, device=dev)
    out = torch.empty((out_slots,), dtype=torch.float32, device=dev)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().sg_segments(
            x.data_ptr(), x.numel(), build.dtype_code(x), build.DTYPE_CODES[compute_dtype],
            _PROLOGUE_CODES[prologue], int(bool(census)), dmaps.data_ptr(), maps.shape[1], c,
            nseg, int(x.data_ptr() % 16 == 0), steps, ops.ctypes.data, p0.ctypes.data,
            p1.ctypes.data, sub.data_ptr(), out.data_ptr(),
            common.fold_tickets("segments", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_sum_segments")
    common.record_io(mma_sum_segments, launch_io)
    return out
