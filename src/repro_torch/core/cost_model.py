"""Cost models of the full reduction: the paper's step model, the lane
geometry the kernels launch, and the bytes they move.

A torch-free copy of the parts of ``repro/core/cost_model.py`` the full
reduction's kernels (K1, K2, K3, K10) and traces are held to. It counts
model steps, MMAs and bytes only; it states no rate of any device (the
card's rates are in ``chip_smoke.py``, beside the numbers measured there).

Paper model (section IV.B): coalesced r/w = 1, tile fill = 1, MMA = 1,
result write = 1, so

  T_tc(n) = 5 log_{m^2}(n)       (eq. 16)
  T_classic(n) = 4 log_2(n)      (the pairwise baseline)
  S = (4/5) log_2(m^2)           (eq. 17)

Also the models of the multi-reduce and scan kernels: the segmented
gather (K8), the parts pass (K4) and the triangular scan (K9; the
reference's striped model, and the port's own look-back kernel beside it,
``lookback_scan_hbm_bytes``), the staged comparison points
(``staged_fused_hbm_bytes``, ``staged_sumsq_hbm_bytes``), the launch bytes
of the port's fused kernels (``fused_launch_bytes``) and the eq. 13 table
(``model_table``), and the interconnect model of the fixed-order combine
(``interconnect_bytes``, ``IciTraffic``; the names kept so a reader finds
the counterpart). Not copied: ``ICI_BW``, whose rate is a TPU's; the
combine's time bound takes the rate of the transport in use instead
(``link_bytes_per_s``).

The card's rates (``HBM_BYTES_PER_S``, ``BF16_TENSOR_FLOPS``,
``F32_CUDA_CORE_FLOPS``, ``SM_CLOCK_HZ``; an H100 SXM at its 700 W limit)
live here and nowhere else: every bound the repository states for the card
(``chip_smoke.py``'s kernel bounds, the probes under ``tools/``) is taken
from them, and so is ``gpu_reduction_roofline``, the card's counterpart of
the reference's ``tpu_reduction_roofline``: where the MMA encoding of a
reduction lands on the card, against the stream bound and the classic tree.
"""

from __future__ import annotations

import dataclasses
import math

M = 128  # the paper's tile size m as the kernels run it (common.MXU)

# The card every bound is stated for, as ``nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader`` names it, and its data-sheet rates.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES_PER_S = 3.35e12       # HBM3 stream rate
BF16_TENSOR_FLOPS = 989e12      # dense bf16 on the tensor cores, f32 accumulate
F32_CUDA_CORE_FLOPS = 67e12     # f32 on the CUDA cores, an FMA counted as 2
SM_CLOCK_HZ = 1.98e9            # the SMs' boost clock: 132 SMs x 128 lanes x 2 x clock = 67 TF

_F32 = 4  # partials, accumulators and outputs are f32


# ----------------------------- paper's model --------------------------------


def t_tensor_core(n: float, m: int) -> float:
    """Paper eq. (16): T_tc(n) = 5 log_{m^2}(n), in model steps."""
    if n <= 1:
        return 0.0
    return 5.0 * math.log(n, m * m)


def t_classic(n: float) -> float:
    """The paper's classic pairwise reduction: T(n) = 4 log2(n)."""
    if n <= 1:
        return 0.0
    return 4.0 * math.log2(n)


def speedup_model(m: int) -> float:
    """Paper eq. (17): S = (4/5) log2(m^2)."""
    return 0.8 * math.log2(m * m)


def levels(n: int, m: int) -> int:
    """Two-MMA passes (launches) the hierarchy of eq. 13 runs on n elements."""
    if n <= 1:
        return 0
    group, out = m * m, 0
    while n > 1:
        n = -(-n // group)
        out += 1
    return out


# ------------------------- striped lane geometry ------------------------------


@dataclasses.dataclass(frozen=True)
class MmaOpCount:
    """MMA count of one striped fused pass: ``lane`` main-stream MMAs per
    lane (the lanes run concurrently), ``combine`` collapse and fold MMAs
    after the lanes join."""

    n: int
    m: int
    num_cores: int  # effective lanes (clamped to the block count)
    lane: int
    combine: int
    serial_tail: int | None = None

    @property
    def total(self) -> int:
        return self.num_cores * self.lane + self.combine

    @property
    def critical_path(self) -> int:
        return self.lane + (self.combine if self.serial_tail is None else self.serial_tail)


def stripe_geometry(tiles: int, tiles_per_block: int, num_cores: int):
    """``(r, c, blocks_per_lane, padded_tiles)`` of a striped tile stream:
    block depth, effective lane count (never more lanes than blocks), blocks
    per lane and the padded tile count ``r * c * blocks_per_lane``. The one
    source of the geometry: the fused kernels' wrappers launch this grid."""
    r = max(1, min(tiles_per_block, tiles))
    blocks = -(-tiles // r)
    c = max(1, min(num_cores, blocks))
    blocks_per_lane = -(-blocks // c)
    return r, c, blocks_per_lane, r * c * blocks_per_lane


def fused_mma_ops(n: int, m: int = M, num_cores: int = 1, tiles_per_block: int = 8,
                  dual: bool = False) -> MmaOpCount:
    """MMAs of the striped fused kernel: padded tiles / c per lane, c lane
    collapses plus one fold; ``dual`` (moments) doubles both."""
    tiles = max(1, -(-n // (m * m)))
    _, c, _, tpad = stripe_geometry(tiles, tiles_per_block, num_cores)
    k = 2 if dual else 1
    return MmaOpCount(n=n, m=m, num_cores=c, lane=k * (tpad // c), combine=k * (c + 1))


@dataclasses.dataclass(frozen=True)
class ScanMmaOps:
    """MMAs of one triangular-scan pass on a CONTIGUOUS lane partition (lane
    ci owns blocks [ci bpl, (ci + 1) bpl)): two carry MMAs per tile (T1 = X
    @ J, D = Ls @ T1) in both the carry rebuild and the owned stripe, plus
    R = X @ U on owned tiles. Lanes do different amounts of work, so this
    is not an ``MmaOpCount``."""

    n: int
    m: int
    num_cores: int       # effective lanes (clamped to the block count)
    tiles: int           # padded tile count (r * c * blocks_per_lane)
    lane_scan: int       # MMAs on one lane's owned stripe (3 per tile)
    carry_worst: int     # carry-rebuild MMAs on the last lane (2 per tile)

    @property
    def total(self) -> int:
        t_per = self.tiles // self.num_cores
        return self.num_cores * self.lane_scan + sum(
            2 * t_per * ci for ci in range(self.num_cores))

    @property
    def critical_path(self) -> int:
        return self.carry_worst + self.lane_scan


def scan_mma_ops(n: int, m: int = M, num_cores: int = 1, tiles_per_block: int = 8) -> ScanMmaOps:
    """MMAs of the triangular scan: ``stripe_geometry`` with the lanes as
    contiguous ranges; one lane gives the serial count 3 * tiles."""
    tiles = max(1, -(-n // (m * m)))
    _, c, _, tpad = stripe_geometry(tiles, tiles_per_block, num_cores)
    per_lane_tiles = tpad // c
    return ScanMmaOps(n=n, m=m, num_cores=c, tiles=tpad, lane_scan=3 * per_lane_tiles,
                      carry_worst=2 * per_lane_tiles * (c - 1))


def segmented_mma_ops(n: int, tiles: int, flushes: int, m: int = M, num_cores: int = 1,
                      max_lane_flushes: int | None = None) -> MmaOpCount:
    """MMAs of the segmented gather: tile-granular striping of the cover's
    ``tiles`` over the lanes, one collapse MMA per lane-aware flush (the
    worst lane's share, ``max_lane_flushes``, on the critical path; all of
    ``flushes`` when unknown). One lane gives n/m^2 + S."""
    _, c, _, tpad = stripe_geometry(tiles, 1, num_cores)
    return MmaOpCount(n=n, m=m, num_cores=c, lane=tpad // c, combine=flushes,
                      serial_tail=flushes if max_lane_flushes is None else max_lane_flushes)


# ------------------------------ bytes moved ----------------------------------


@dataclasses.dataclass(frozen=True)
class HbmTraffic:
    """Bytes of one reduction, split along the launch boundary:
    ``kernel_read`` / ``kernel_write`` are the operands and results crossing
    the launches (``launch_io``); ``stage_*`` are copies made before a
    launch; ``combine_*`` the host-side combine of the partials."""

    kernel_read: int
    kernel_write: int
    stage_read: int = 0
    stage_write: int = 0
    combine_read: int = 0
    combine_write: int = 0
    refetch_read: int = 0

    @property
    def launch_io(self) -> int:
        return self.kernel_read + self.kernel_write

    @property
    def read(self) -> int:
        return self.kernel_read + self.stage_read + self.combine_read + self.refetch_read

    @property
    def write(self) -> int:
        return self.kernel_write + self.stage_write + self.combine_write

    @property
    def total(self) -> int:
        return self.read + self.write


def fused_hbm_bytes(n: int, itemsize: int, *, m: int = M, num_cores: int = 1,
                    tiles_per_block: int = 8, kahan: bool = False, dual: bool = False,
                    epilogue: bool = False) -> HbmTraffic:
    """One fused pass: the buffer read once at its own width, C lane
    partials written ((C, 2, m, m) under the Kahan carry or the moments
    pair) and read back by the combine, which writes the scalar (a pair
    for moments). ``epilogue`` is the in-kernel finish of a single-lane
    launch: one f32 leaves the launch."""
    tiles = max(1, -(-n // (m * m)))
    _, c, _, _ = stripe_geometry(tiles, tiles_per_block, num_cores)
    if epilogue:
        if c != 1 or kahan or dual:
            raise ValueError(
                "in-kernel fused epilogue requires a single-lane, non-kahan, non-dual "
                f"launch; got c={c}, kahan={kahan}, dual={dual}"
            )
        return HbmTraffic(kernel_read=n * itemsize, kernel_write=_F32)
    partials = (2 if (kahan or dual) else 1) * c * m * m * _F32
    return HbmTraffic(kernel_read=n * itemsize, kernel_write=partials,
                      combine_read=partials, combine_write=(2 if dual else 1) * _F32)


def staged_sumsq_hbm_bytes(n: int, itemsize: int, *, m: int = M, num_cores: int = 1,
                           tiles_per_block: int = 8) -> HbmTraffic:
    """The sumsq ingestion before the in-kernel square (the comparison
    point): the squares taken at f32 on the host first (read n * itemsize,
    write n * 4), then the fused pass over that f32 temporary."""
    zc = fused_hbm_bytes(n, _F32, m=m, num_cores=num_cores, tiles_per_block=tiles_per_block)
    return HbmTraffic(kernel_read=zc.kernel_read, kernel_write=zc.kernel_write,
                      stage_read=n * itemsize, stage_write=n * _F32,
                      combine_read=zc.combine_read, combine_write=zc.combine_write)


def staged_fused_hbm_bytes(n: int, itemsize: int, *, m: int = M, num_cores: int = 1,
                           tiles_per_block: int = 8, kahan: bool = False) -> HbmTraffic:
    """The ingestion before zero-copy (the comparison point, and the model of
    a dtype the kernels do not read): a padded f32 copy of the input made
    before the launch (read n * itemsize, write tpad m^2 f32), which the
    kernel then reads in place of the caller's data."""
    tiles = max(1, -(-n // (m * m)))
    _, c, _, tpad = stripe_geometry(tiles, tiles_per_block, num_cores)
    staged = tpad * m * m * _F32
    partials = (2 if kahan else 1) * c * m * m * _F32
    return HbmTraffic(kernel_read=staged, kernel_write=partials, stage_read=n * itemsize,
                      stage_write=staged, combine_read=partials, combine_write=_F32)


def fused_launch_bytes(n: int, itemsize: int, *, num_lanes: int = 1, tiles_per_block: int = 8,
                       m: int = M, outputs: int = 1, kahan: bool = False) -> HbmTraffic:
    """What one launch of the port's fused kernels (K1, K2, K3) moves; no
    counterpart in the reference, whose lanes write (C, m, m) partials for
    a combine after the launch. The buffer is read once at its own width;
    the launch writes its ``outputs`` finished f32 scalars (1 for a sum, 2
    for a sum with its census or the moments pair). With C > 1 lanes each
    lane's CTA also writes two 4-byte words (its partial and its count, or
    the moments pair) that the last CTA reads back; under the Kahan carry
    every lane, one lane included, writes its (s, c) pair."""
    tiles = max(1, -(-n // (m * m)))
    _, c, _, _ = stripe_geometry(tiles, tiles_per_block, num_lanes)
    lane_words = 2 * c * 4 if (c > 1 or kahan) else 0
    return HbmTraffic(kernel_read=n * itemsize + lane_words,
                      kernel_write=outputs * _F32 + lane_words)


def hier_hbm_bytes(n: int, itemsize: int, *, m: int = M,
                   tiles_per_block: int = 8) -> HbmTraffic:
    """The hierarchy of eq. 13: level 0 reads the buffer at its own width;
    every level writes its block-padded f32 partials and the next level
    reads the t real ones back."""
    group = m * m
    kread, kwrite, size, bs = 0, 0, max(n, 1), itemsize
    while size > 1:
        kread += size * bs
        t = -(-size // group)
        r = max(1, min(tiles_per_block, t))
        kwrite += -(-t // r) * r * _F32
        size = t
        bs = _F32
    return HbmTraffic(kernel_read=kread, kernel_write=kwrite)


def hier_moments_hbm_bytes(n: int, itemsize: int, *, m: int = M,
                           tiles_per_block: int = 8) -> HbmTraffic:
    """The hierarchy under the moments prologue: level 0 reads the buffer
    once and writes a (tpad, 2) pair; each f32 column then climbs the
    identity hierarchy."""
    group = m * m
    size = max(n, 1)
    t = -(-size // group)
    r = max(1, min(tiles_per_block, t))
    tpad = -(-t // r) * r
    upper = hier_hbm_bytes(t, _F32, m=m, tiles_per_block=tiles_per_block)
    return HbmTraffic(kernel_read=size * itemsize + 2 * upper.kernel_read,
                      kernel_write=2 * tpad * _F32 + 2 * upper.kernel_write)


def blocked_hier_hbm_bytes(n: int, itemsize: int, block: int, *, m: int = M,
                           tiles_per_block: int = 8) -> HbmTraffic:
    """The blocked compensated combine on the hierarchy (``precision=
    "kahan"`` on ``cuda_hier``): one staging copy lays the f32 blocks of
    ``block`` elements out with each block padded to whole tiles (read the
    buffer, write the padded stream); then every level reduces all blocks
    at once (level 0 reads the staged stream, each level writes its
    block-padded partials), and the host reads the block totals back for
    the serial Kahan pass. With ``block <= m^2`` that is one launch."""
    group = m * m
    nblk = max(1, -(-n // block))
    kread = kwrite = 0
    sread, swrite = n * itemsize, 0
    size = block
    while True:
        kb = -(-size // group)  # tiles per block at this level
        swrite += nblk * kb * group * _F32
        kread += nblk * kb * group * _F32
        t = nblk * kb
        r = max(1, min(tiles_per_block, t))
        kwrite += -(-t // r) * r * _F32
        if kb == 1:
            break
        # a block spans several tiles: its partials are laid out again,
        # each block's padded to whole tiles, for the next level
        sread += t * _F32
        size = kb
    return HbmTraffic(kernel_read=kread, kernel_write=kwrite, stage_read=sread,
                      stage_write=swrite, combine_read=nblk * _F32, combine_write=_F32)


def segmented_hbm_bytes(fetched_elems: int, itemsize: int, *, segments: int, tiles: int = 0,
                        m: int = M, num_cores: int = 1) -> HbmTraffic:
    """The segmented gather: every cover tile is one m^2-aligned block of the
    caller's buffer (``fetched_elems`` counts them, clipped to the buffer:
    n plus one block per non-aligned boundary), plus five (tpad,) int32
    cover maps read; (C, S) lane sub-partials written, read back by the
    lane fold, which writes the (S,) result."""
    _, c, _, tpad = stripe_geometry(max(tiles, 1), 1, num_cores)
    sub = c * segments * _F32
    return HbmTraffic(kernel_read=fetched_elems * itemsize + 5 * tpad * 4, kernel_write=sub,
                      combine_read=sub, combine_write=segments * _F32)


def parts_hbm_bytes(part_bytes: int, *, segments: int) -> HbmTraffic:
    """The parts pass: every part read once at its own width (``part_bytes``
    summed over the live parts), the output row of ``segments`` f32 slots
    written; no combine."""
    return HbmTraffic(kernel_read=part_bytes, kernel_write=segments * _F32)


def scan_hbm_bytes(n: int, itemsize: int, *, out_itemsize: int | None = None, m: int = M,
                   num_cores: int = 1, tiles_per_block: int = 8) -> HbmTraffic:
    """The triangular scan: the buffer read once at its own width, the
    block-padded prefix written in the output dtype; ``refetch_read``
    charges each lane's carry rebuild (lane ci re-reads blocks [0, ci
    bpl), clipped to n), outside ``launch_io``."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    tiles = max(1, -(-n // (m * m)))
    r, c, bpl, tpad = stripe_geometry(tiles, tiles_per_block, num_cores)
    block_elems = r * m * m
    refetch = sum(min(ci * bpl * block_elems, n) for ci in range(c))
    return HbmTraffic(kernel_read=n * itemsize, kernel_write=tpad * m * m * out_itemsize,
                      refetch_read=refetch * itemsize)


def lookback_scan_hbm_bytes(n: int, itemsize: int, *, out_itemsize: int | None = None,
                            m: int = M) -> HbmTraffic:
    """The port's scan kernel (one tile per CTA, carries by look-back; no
    counterpart in the reference): the buffer read once at its own width,
    the tile-padded prefix written once in the output dtype, and the
    look-back state written once (a ticket word and one 8-byte word per
    tile). No refetch at any lane count: lanes and block depth do not
    enter."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    tiles = max(1, -(-n // (m * m)))
    return HbmTraffic(kernel_read=n * itemsize,
                      kernel_write=tiles * m * m * out_itemsize + 8 * (tiles + 1))


def staged_scan_hbm_bytes(n: int, itemsize: int, *, m: int = M, num_cores: int = 1,
                          tiles_per_block: int = 8) -> HbmTraffic:
    """The staged comparison for a sub-f32 cumsum: an f32 copy of the input
    (read n * itemsize, write n * 4), the scan at f32, and the result cast
    back (read n * 4, write n * itemsize)."""
    zc = scan_hbm_bytes(n, _F32, out_itemsize=_F32, m=m, num_cores=num_cores,
                        tiles_per_block=tiles_per_block)
    return HbmTraffic(kernel_read=zc.kernel_read, kernel_write=zc.kernel_write,
                      stage_read=n * itemsize, stage_write=n * _F32, combine_read=n * _F32,
                      combine_write=n * itemsize, refetch_read=zc.refetch_read)


def hbm_bytes(path: str, n: int, itemsize: int, *, m: int = M, num_cores: int = 1,
              tiles_per_block: int = 8, kahan: bool = False, dual: bool = False,
              segments: int = 1, tiles: int = 0, fetched_elems: int | None = None,
              epilogue: bool = False, census: int = 0) -> HbmTraffic:
    """Dispatch over the models: ``path`` is "fused", "fused_staged",
    "sumsq_staged", "hier", "hier_moments", "segmented", "parts",
    "parts_2trip", "scan" or "scan_staged" (the reference's).
    ``census`` widens the output of the multi-reduce paths by that many f32
    slots (no input bytes); for "parts", ``n * itemsize`` is the parts'
    summed bytes."""
    if path == "fused":
        return fused_hbm_bytes(n, itemsize, m=m, num_cores=num_cores,
                               tiles_per_block=tiles_per_block, kahan=kahan, dual=dual,
                               epilogue=epilogue)
    if path == "fused_staged":
        return staged_fused_hbm_bytes(n, itemsize, m=m, num_cores=num_cores,
                                      tiles_per_block=tiles_per_block, kahan=kahan)
    if path == "sumsq_staged":
        return staged_sumsq_hbm_bytes(n, itemsize, m=m, num_cores=num_cores,
                                      tiles_per_block=tiles_per_block)
    if path == "hier":
        return hier_hbm_bytes(n, itemsize, m=m, tiles_per_block=tiles_per_block)
    if path == "hier_moments":
        return hier_moments_hbm_bytes(n, itemsize, m=m, tiles_per_block=tiles_per_block)
    if path == "segmented":
        return segmented_hbm_bytes(fetched_elems if fetched_elems is not None else n, itemsize,
                                   segments=segments + census, tiles=tiles, m=m,
                                   num_cores=num_cores)
    if path == "parts":
        return parts_hbm_bytes(n * itemsize, segments=segments + census)
    if path == "scan":
        return scan_hbm_bytes(n, itemsize, m=m, num_cores=num_cores,
                              tiles_per_block=tiles_per_block)
    if path == "scan_staged":
        return staged_scan_hbm_bytes(n, itemsize, m=m, num_cores=num_cores,
                                     tiles_per_block=tiles_per_block)
    if path == "parts_2trip":
        # the comparison for the optimizer step before the epilogue fork:
        # the norm launch streams the gradients, then the update reads them again
        base = parts_hbm_bytes(n * itemsize, segments=segments + census)
        return HbmTraffic(kernel_read=base.kernel_read + n * itemsize,
                          kernel_write=base.kernel_write)
    raise ValueError(f"unknown hbm_bytes path {path!r}")


# --------------------- step-model table (benchmarks) ------------------------


def model_table(ns=(2**10, 2**16, 2**20, 2**26, 2**30), ms=(2, 4, 16, 128)):
    """Rows of (n, m, T_tc, T_classic, S_model) for the paper's tables."""
    rows = []
    for n in ns:
        for m in ms:
            rows.append(dict(
                n=n, m=m, t_tc=t_tensor_core(n, m), t_classic=t_classic(n),
                speedup=t_classic(n) / max(t_tensor_core(n, m), 1e-12),
                speedup_closed_form=speedup_model(m),
            ))
    return rows


# ------------------------- interconnect traffic ------------------------------

# NVLink of an H100 SXM: 900 GB/s to the other cards of the host, all to
# all, 450 GB/s each way (NVIDIA's data sheet).
NVLINK_H100_BYTES_PER_S = 450e9


def link_bytes_per_s(transport: str):
    """The per-direction link rate a combine's bytes cross under
    ``transport``: NVLink's for NCCL between H100 cards; None for gloo,
    whose bytes go through the host (no link rate stands for it)."""
    return {"nccl": NVLINK_H100_BYTES_PER_S, "gloo": None}[transport]


@dataclasses.dataclass(frozen=True)
class IciTraffic:
    """Bytes of one fixed-order combine of ``slots`` f32 partials across a
    ``world``-rank mesh axis: ONE all-gather, after which every rank folds
    the P rows itself (no reduction on the wire, which is what makes the
    result bitwise the same on every rank). ``recv_per_device`` is held
    EQUAL to ``reduce.inspect.collective_recv_bytes`` of the call, as
    ``ReducePlan.hbm_bytes`` is to the launches' bytes."""

    slots: int
    world: int
    itemsize: int = _F32
    link_bytes_per_s: float | None = None

    @property
    def recv_per_device(self) -> int:
        """Bytes into each rank: the other P - 1 rows."""
        return (self.world - 1) * self.slots * self.itemsize

    @property
    def send_per_device(self) -> int:
        """Bytes out of each rank: its row to the other P - 1."""
        return (self.world - 1) * self.slots * self.itemsize

    @property
    def wire_total(self) -> int:
        return self.world * self.recv_per_device

    @property
    def time_s(self) -> float:
        """Least time of the gather at the transport's link rate; a
        transport without one (gloo through the host) has no bound."""
        if self.link_bytes_per_s is None:
            raise ValueError("this transport has no link rate (gloo goes through the host): "
                             "the combine's time has no bound here")
        return self.recv_per_device / self.link_bytes_per_s

    def vs_psum_recv(self) -> float:
        """Against an ideal reduce-scatter + gather all-reduce of the same
        row (about 2 x slots x itemsize a rank whatever P): the fixed order
        costs O(P) gathered bytes."""
        return self.recv_per_device / max(2 * self.slots * self.itemsize, 1)


def interconnect_bytes(slots: int, world: int, *, itemsize: int = _F32,
                       transport: str | None = None) -> IciTraffic:
    """Traffic of the ``mesh_axes=`` reduce path: the rank's additive row
    (per-leaf slots, raw total, census counts) gathered once and folded on
    each rank. ``world`` is the axis size (several axes combine one at a
    time: sum one instance per axis); ``transport`` ("nccl" or "gloo")
    sets the link rate of ``time_s``."""
    if slots < 0 or world < 1:
        raise ValueError(f"invalid interconnect geometry: {slots=} {world=}")
    rate = None if transport is None else link_bytes_per_s(transport)
    return IciTraffic(slots=slots, world=world, itemsize=itemsize, link_bytes_per_s=rate)


# --------------------------- the card's roofline ------------------------------


@dataclasses.dataclass(frozen=True)
class ReductionRoofline:
    """Three-term roofline for reducing n elements of ``bytes_per_el`` on
    the card; the reference's TPU terms under the card's unit names:

      hbm_s          <- hbm_s   the operand streamed from HBM once;
      cuda_core_s    <- vpu_s   the classic tree on the CUDA cores (one
                                f32 add an element at the f32 rate, an FMA
                                slot each, plus a log-depth tail of 10
                                cycles a level), operand on chip;
      tensor_core_s  <- mxu_s   the paper's MMA encoding at tile size m
                                (``tensor_flops`` at the dense bf16 tensor
                                rate), operand on chip.

    ``tensor_core_bandwidth_neutral`` is the reference's
    ``mxu_bandwidth_neutral``."""

    n: int
    bytes_per_el: int
    m: int
    hbm_s: float
    cuda_core_s: float
    tensor_core_s: float
    tensor_flops: float

    @property
    def cold_bound_s(self) -> float:
        """A cold reduction can never beat the stream time, nor the MMAs'."""
        return max(self.hbm_s, self.tensor_core_s)

    @property
    def fused_speedup(self) -> float:
        """CUDA-core / tensor-core time for an on-chip (fused) reduction:
        below 1 where the tensor cores take longer, which is the price of
        leaving the CUDA cores free for the surrounding kernel."""
        return self.cuda_core_s / self.tensor_core_s if self.tensor_core_s else float("inf")

    @property
    def tensor_core_bandwidth_neutral(self) -> bool:
        """True when the MMA encoding adds no wall time over the HBM stream
        bound for a cold operand (within 1.15x of the stream)."""
        return self.tensor_core_s <= self.hbm_s * 1.15


def reduction_mma_flops(n: int, m: int = M) -> float:
    """The reference's MMA-FLOP count of the eq. 13 hierarchy: level by
    level, k = ceil(remaining / m^2) tiles, each 2 MMAs of 2 m^3 FLOPs,
    until one value is left (``tpu_reduction_roofline``'s loop, with m a
    parameter)."""
    group = m * m
    flops, remaining = 0.0, n
    while remaining > 1:
        k = -(-remaining // group)
        flops += 2 * k * 2 * m**3
        remaining = k
    return flops


def gpu_reduction_roofline(n: int, bytes_per_el: int = 2, *, m: int = M) -> ReductionRoofline:
    """Where a reduction of n elements lands on the card (``CARD``): the
    stream, the classic tree on the CUDA cores and the MMA encoding on the
    tensor cores (``ReductionRoofline``). ``m``: the tile size of the
    encoding (the port's kernels run 128; the paper's Volta WMMA tile is
    16)."""
    hbm_s = n * bytes_per_el / HBM_BYTES_PER_S
    cuda_core_s = n / (F32_CUDA_CORE_FLOPS / 2) + 10 * math.log2(max(n, 2)) / SM_CLOCK_HZ
    flops = reduction_mma_flops(n, m)
    return ReductionRoofline(n=n, bytes_per_el=bytes_per_el, m=m, hbm_s=hbm_s,
                             cuda_core_s=cuda_core_s, tensor_core_s=flops / BF16_TENSOR_FLOPS,
                             tensor_flops=flops)
