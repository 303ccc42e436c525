"""The one-launch multi-part reduction behind ``reduce_tree``.

Port of ``repro/kernels/mma_reduce``'s parts path: ``parts_layout``,
``PARTS_KERNEL_MAX`` and ``mma_sum_parts`` (the counterpart of
``mma_sum_parts_pallas``; kernel ``parts_accumulate_kernel``). S separate
arrays go into one launch, each in its own dtype with no packing copy; the
output row is ``[S part totals][K chains of the cross-part total][S
non-finite counts][1 total count]`` (the last two with ``census=True``).

On CUDA tensors ``mma_sum_parts`` launches ``csrc/parts_reduce.cu``; on CPU
tensors it runs ``mma_sum_parts_plain``, which folds in the kernel's order:
each part's m^2-element tiles in order, then the parts in order, in f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build, common

MXU = common.MXU
TILE = MXU * MXU
# Live parts one launch takes (the kernel's by-value table); past this the
# reduce backends fold host-side, as the reference's backends do.
PARTS_KERNEL_MAX = 128
MAX_CHAINS = 4        # csrc/parts_reduce.cu PR_MAX_CHAINS
MAX_CHAIN_STEPS = 4   # csrc/parts_reduce.cu PR_MAX_STEPS
_PROLOGUE_CODES = {"identity": 0, "square": 1, "abs": 2}


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


# One fold ticket per (device, stream), zeroed once at first use. The
# kernel's last CTA sets it back to 0, and launches on one stream run in
# order, so each launch finds it zeroed.
_TICKETS: dict = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _TICKETS[key]


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
            out.data_ptr(), scratch.data_ptr(), _ticket(dev, stream).data_ptr(), stream,
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
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    parts = tuple(parts)
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
