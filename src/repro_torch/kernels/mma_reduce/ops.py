"""The one-launch reductions behind ``reduce`` and ``reduce_tree``.

Port of ``repro/kernels/mma_reduce``'s fused and parts paths:

  mma_sum_fused  -- the striped single-launch full reduction (the
                    counterpart of ``mma_sum_pallas(mode="fused")``; kernel
                    ``fused_accumulate_kernel``): one array, prologue,
                    epilogue chain and NaN/Inf census, lanes of
                    blocks of m^2 tiles, folded by
                    ``combine_lane_partials``. CUDA: ``csrc/fused_reduce.cu``.
  mma_sum_parts  -- S separate arrays in one launch (the counterpart of
                    ``mma_sum_parts_pallas``; kernel
                    ``parts_accumulate_kernel``), each in its own dtype with
                    no packing copy; the output row is ``[S part totals][K
                    chains of the cross-part total][S non-finite counts][1
                    total count]`` (the last two with ``census=True``).
                    CUDA: ``csrc/parts_reduce.cu``.

On CPU tensors each wrapper runs its plain version, which folds in the
kernel's order where f32 adds decide it (the lane fold, the parts' tiles
and parts). Neither wrapper records a gradient: called on an input that
requires grad it raises and names ``repro_torch.reduce.reduce``, whose
``_ksum`` Function differentiates the full reduction.

Not ported: the dual-accumulator moments kernel (K2), the per-lane Kahan
kernel (K3), and bf16/f16 compute in the parts kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
_PROLOGUE_CODES = {"identity": 0, "square": 1, "abs": 2}
_NATIVE = (torch.float32, torch.bfloat16, torch.float16)


# ------------------------------ fused (K1) ------------------------------------


def lane_geometry(n: int, num_lanes: int = 1):
    """``(r, c, blocks_per_lane, padded_tiles)`` of a striped stream of
    ``n`` elements: block depth in m^2 tiles (``TILES_PER_BLOCK``), the
    effective lane count (never more lanes than blocks), blocks per lane,
    and the padded tile count -- the reference's
    ``cost_model.stripe_geometry``."""
    tiles = max(1, common.ceil_div(n, TILE))
    r = max(1, min(TILES_PER_BLOCK, tiles))
    blocks = common.ceil_div(tiles, r)
    c = max(1, min(num_lanes, blocks))
    blocks_per_lane = common.ceil_div(blocks, c)
    return r, c, blocks_per_lane, r * c * blocks_per_lane


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


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """f32 values rounded to the compute dtype, kept in f32."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).to(torch.float32)


def mma_sum_fused_plain(x: torch.Tensor, compute_dtype=torch.bfloat16, prologue="identity",
                        epilogue=(), census: bool = False, num_lanes: int = 1):
    """Plain PyTorch version of the fused kernel: every element cast to the
    compute dtype, counted if non-finite, mapped by the prologue at the
    compute dtype; lane c sums blocks c, c + C, ... in f32; the lanes fold
    by ``combine_lane_partials``; the chain maps the total. Returns the
    total, or ``(total, count)`` with ``census``."""
    chain = common.normalize_epilogue(epilogue)
    flat = _round(x.reshape(-1).to(torch.float32), compute_dtype)
    n = flat.numel()
    count = torch.sum(~torch.isfinite(flat)).to(torch.float32)
    if prologue == "square":
        flat = _round(flat * flat, compute_dtype)
    elif prologue == "abs":
        flat = torch.abs(flat)
    r, c, bpl, tpad = lane_geometry(n, num_lanes)
    blocks = torch.nn.functional.pad(flat, (0, tpad * TILE - n)).view(bpl, c, r * TILE)
    total = common.apply_epilogue(combine_lane_partials(torch.sum(blocks, dim=(0, 2))), chain)
    return (total, count) if census else total


# One fold ticket per (kernel, device, stream), zeroed once at first use. A
# kernel's last CTA sets it back to 0, and launches on one stream run in
# order, so each launch finds it zeroed.
_TICKETS: dict = {}


def _ticket(kernel: str, dev: torch.device, stream: int) -> torch.Tensor:
    key = (kernel, dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _TICKETS[key]


def _launch_fused(flat, compute_dtype, prologue, chain, census, num_lanes):
    n = flat.numel()
    r, c, _, _ = lane_geometry(n, num_lanes)
    blocks = common.ceil_div(max(1, common.ceil_div(n, TILE)), r)
    enc = common.encode_epilogue(chain)
    if len(enc) > FUSED_MAX_CHAIN_STEPS:
        raise ValueError(f"a chain takes at most {FUSED_MAX_CHAIN_STEPS} steps; got {chain!r}")
    ops = np.array([op for op, _, _ in enc] or [0], dtype=np.int32)
    p0 = np.array([a for _, a, _ in enc] or [0.0], dtype=np.float32)
    p1 = np.array([b for _, _, b in enc] or [0.0], dtype=np.float32)
    dev = flat.device
    out = torch.empty((2 if census else 1,), dtype=torch.float32, device=dev)
    # c f32 lane sums and c int32 lane counts: every CTA writes its own
    scratch = torch.empty((2 * c,), dtype=torch.int32, device=dev)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().fr_sum(
            flat.data_ptr(), n, build.dtype_code(flat), build.DTYPE_CODES[compute_dtype],
            _PROLOGUE_CODES[prologue], int(bool(census)), r * TILE, blocks, c,
            int(flat.data_ptr() % 16 == 0), len(enc), ops.ctypes.data, p0.ctypes.data,
            p1.ctypes.data, out.data_ptr(), scratch.data_ptr(),
            _ticket("fused", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_sum_fused")
    return out


@common.counted("mma_sum_fused")
def mma_sum_fused(
    x: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    prologue: str = "identity",
    epilogue=(),
    census: bool = False,
    num_lanes: int = 1,
):
    """Sum all (prologue-mapped) elements of ``x`` in ONE kernel launch ->
    f32 scalar, or ``(total, count)`` with ``census`` (the NaN/Inf count of
    the compute-cast elements, before the prologue). ``epilogue`` maps the
    total in-launch. ``num_lanes`` stripes the blocks over that many CTAs
    (clamped to the block count); the lane fold is fixed, so the result is
    bitwise reproducible at a given lane count. Blocks are
    ``TILES_PER_BLOCK`` m^2 tiles, the reference's default depth. bf16/f16 compute runs the
    ones-MMA on tensor cores; f32 compute sums on CUDA cores. Input other
    than f32/bf16/f16 is cast to f32 first (one staging copy, as the
    reference's ``_ingest``). CPU tensors: plain version."""
    common.refuse_grad("mma_sum_fused", x, entry="repro_torch.reduce.reduce(x, axis=None)")
    if prologue not in ELEMENTWISE_PROLOGUES:
        raise ValueError(f"prologue must be one of {ELEMENTWISE_PROLOGUES}; got {prologue!r}")
    if compute_dtype not in _NATIVE:
        raise ValueError(f"compute dtype must be one of {_NATIVE}; got {compute_dtype}")
    if num_lanes < 1:
        raise ValueError(f"num_lanes must be >= 1; got {num_lanes}")
    chain = common.normalize_epilogue(epilogue)
    if x.numel() == 0:  # nothing streamed: the chain of a zero total, count 0
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        total = common.apply_epilogue(zero, chain)
        return (total, zero.clone()) if census else total
    if common.on_cpu(x):
        return mma_sum_fused_plain(x, compute_dtype, prologue, chain, census, num_lanes)
    flat = x.reshape(-1)
    if flat.dtype not in _NATIVE:
        flat = flat.to(torch.float32)
    out = _launch_fused(flat.contiguous(), compute_dtype, prologue, chain, census, num_lanes)
    mma_sum_fused.launches += 1
    return (out[0], out[1]) if census else out[0]


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


def _empty_row(nseg, total_chains, census, device) -> torch.Tensor:
    """Every part empty: zero totals, each chain of a zero total, and (with
    census) zero counts -- nothing streamed, nothing non-finite."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    pieces = [torch.zeros((nseg,), dtype=torch.float32, device=device)]
    if total_chains:
        pieces.append(torch.stack([common.apply_epilogue(zero, ch) for ch in total_chains]))
    if census:
        pieces.append(torch.zeros((nseg + 1,), dtype=torch.float32, device=device))
    return torch.cat(pieces)


def mma_sum_parts_plain(parts, prologues, total_chains, census) -> torch.Tensor:
    """Plain PyTorch version of the parts kernel (f32 compute): per tile an
    f32 sum of the prologue-mapped values and a count of the raw non-finite
    ones; per part a sequential fold of its tiles; then a sequential fold of
    the part totals. Empty parts keep 0."""
    nseg = len(parts)
    dev = parts[0].device
    n_chains = len(total_chains)
    out = torch.zeros((nseg + n_chains + ((nseg + 1) if census else 0),),
                      dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    total_cnt = 0
    for s, (part, pro) in enumerate(zip(parts, prologues)):
        flat = part.reshape(-1).to(torch.float32)
        if flat.numel() == 0:
            continue
        nblk = common.ceil_div(flat.numel(), TILE)
        tiles = torch.nn.functional.pad(flat, (0, nblk * TILE - flat.numel())).view(nblk, TILE)
        sums = torch.sum(common.apply_prologue(tiles, pro), dim=1)
        ps = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(nblk):
            ps = ps + sums[t]
        out[s] = ps
        total = total + ps
        if census:
            cnt = int(torch.sum(~torch.isfinite(flat)))
            out[nseg + n_chains + s] = cnt
            total_cnt += cnt
    for k, ch in enumerate(total_chains):
        out[nseg + k] = common.apply_epilogue(total, ch)
    if census:
        out[-1] = total_cnt
    return out


def _launch(parts, layout, prologues, total_chains, census) -> torch.Tensor:
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
    lens = np.zeros((max(k, 1),), dtype=np.int32)
    ops = np.zeros((max(k, 1), MAX_CHAIN_STEPS), dtype=np.int32)
    p0 = np.zeros((max(k, 1), MAX_CHAIN_STEPS), dtype=np.float32)
    p1 = np.zeros((max(k, 1), MAX_CHAIN_STEPS), dtype=np.float32)
    for i, ch in enumerate(total_chains):
        enc = common.encode_epilogue(ch)
        if len(enc) > MAX_CHAIN_STEPS:
            raise ValueError(f"a chain takes at most {MAX_CHAIN_STEPS} steps; got {ch!r}")
        lens[i] = len(enc)
        for j, (op, a, b) in enumerate(enc):
            ops[i, j], p0[i, j], p1[i, j] = op, a, b
    out = torch.empty((nseg + k + ((nseg + 1) if census else 0),),
                      dtype=torch.float32, device=dev)
    # n_tiles f32 partial sums and n_tiles int32 partial counts: every CTA
    # writes its own, so they need no clearing (and no second launch)
    scratch = torch.empty((2 * n_tiles,), dtype=torch.int32, device=dev)
    stream = build.stream_ptr(out)
    with torch.cuda.device(dev):
        err = build.library().pr_parts(
            ptrs.ctypes.data, sizes.ctypes.data, starts.ctypes.data, segs.ctypes.data,
            dtypes.ctypes.data, pros.ctypes.data, n_live, nseg, lens.ctypes.data,
            ops.ctypes.data, p0.ctypes.data, p1.ctypes.data, k, int(bool(census)),
            out.data_ptr(), scratch.data_ptr(), _ticket("parts", dev, stream).data_ptr(), stream,
        )
    build.check(err, "mma_sum_parts")
    return out


@common.counted("mma_sum_parts")
def mma_sum_parts(
    parts: Sequence[torch.Tensor],
    *,
    compute_dtype=torch.float32,
    prologue="identity",
    total_chains=(),
    census: bool = False,
) -> torch.Tensor:
    """Sum S separate (prologue-mapped) arrays in ONE kernel launch with no
    packing copy -> ``(S + K [+ S + 1],)`` f32 row (see the module doc).

    ``prologue`` is a name or one name per part ("identity", "square",
    "abs"); ``total_chains`` is a tuple of K normalized epilogue chains of
    the cross-part total. The compute dtype is f32 (``reduce_tree`` forces
    it); bf16/f16 compute is not ported and raises NotImplementedError.
    CPU tensors run the plain version; CUDA tensors launch the kernel. Not
    differentiable: an input that requires grad raises."""
    parts = tuple(parts)
    common.refuse_grad("mma_sum_parts", *parts, entry="repro_torch.reduce.reduce_tree")
    nseg = len(parts)
    total_chains = tuple(common.normalize_epilogue(c) for c in total_chains)
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"parts reduction with compute dtype {compute_dtype} is not ported; "
            "only float32 compute (the reduce_tree path) is"
        )
    if nseg == 0:
        if total_chains:
            raise ValueError("total_chains need at least one part")
        if census:
            raise ValueError("census needs at least one part")
        return torch.zeros((0,), dtype=torch.float32)
    pros = common.normalize_part_prologues(prologue, nseg)
    if "moments" in pros:
        raise ValueError("the parts kernel does not take a 'moments' part")
    if len(total_chains) > MAX_CHAINS:
        raise ValueError(f"at most {MAX_CHAINS} total chains; got {len(total_chains)}")
    layout = parts_layout([p.numel() for p in parts], TILE)
    if common.on_cpu(*parts):
        if not layout:
            return _empty_row(nseg, total_chains, census, parts[0].device)
        return mma_sum_parts_plain(parts, pros, total_chains, census)
    if not layout:
        return _empty_row(nseg, total_chains, census, parts[0].device)
    if len(layout) > PARTS_KERNEL_MAX:
        raise ValueError(
            f"{len(layout)} live parts exceed PARTS_KERNEL_MAX={PARTS_KERNEL_MAX}; "
            "the reduce backends fold such trees host-side"
        )
    out = _launch(parts, layout, pros, total_chains, census)
    mma_sum_parts.launches += 1
    return out
