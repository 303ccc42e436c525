"""Port parity: ``repro_torch.core.cost_model`` against
``repro.core.cost_model``, function by function over a grid of n, m, tiles
per block and lanes (the full-reduction, segmented, parts and scan models);
and the fused kernels' launch grids (K1, K2, K3) against the cost model's
``stripe_geometry``.

Every model is exact integer (or float) arithmetic on the same formulas,
so the two sides must be equal.
"""

import contextlib
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import cost_model as RC
from repro_torch.core import cost_model as C
from repro_torch.kernels import build
from repro_torch.kernels.mma_reduce import ops

NS = [1, 2, 100, 16383, 16384, 16385, 3 * 16384 + 5, 131072, 131073, 2**20 + 17, 2**28, 2**28 - 4097]
MS = [2, 4, 16, 128]
TPBS = [1, 3, 8]
LANES = [1, 2, 5, 528]


@pytest.mark.parametrize("m", MS)
def test_step_models_match_reference(m):
    for n in NS + [0, 7, 256, 65536]:
        assert C.t_tensor_core(n, m) == RC.t_tensor_core(n, m)
        assert C.t_classic(n) == RC.t_classic(n)
        assert C.levels(n, m) == RC.levels(n, m)
    assert C.speedup_model(m) == RC.speedup_model(m)


@pytest.mark.parametrize("tpb", TPBS)
@pytest.mark.parametrize("lanes", LANES)
def test_stripe_geometry_and_mma_ops_match_reference(tpb, lanes):
    for tiles in (1, 2, 7, 8, 9, 64, 2048, 16384):
        assert C.stripe_geometry(tiles, tpb, lanes) == RC.stripe_geometry(tiles, tpb, lanes)
    for n, m, dual in itertools.product(NS, (16, 128), (False, True)):
        got = C.fused_mma_ops(n, m, lanes, tpb, dual)
        want = RC.fused_mma_ops(n, m, lanes, tpb, dual)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.total, got.critical_path) == (want.total, want.critical_path)


def _traffic(t) -> tuple:
    return (t.kernel_read, t.kernel_write, t.stage_read, t.stage_write, t.combine_read,
            t.combine_write, t.refetch_read, t.launch_io, t.read, t.write, t.total)


@pytest.mark.parametrize("tpb", TPBS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_hbm_models_match_reference(tpb, itemsize):
    for n, m in itertools.product(NS, (16, 128)):
        for path in ("hier", "hier_moments"):
            got = C.hbm_bytes(path, n, itemsize, m=m, tiles_per_block=tpb)
            want = RC.hbm_bytes(path, n, itemsize, m=m, tiles_per_block=tpb)
            assert _traffic(got) == _traffic(want), (path, n, m)
        assert _traffic(C.hier_hbm_bytes(n, itemsize, m=m, tiles_per_block=tpb)) == _traffic(
            RC.hier_hbm_bytes(n, itemsize, m=m, tiles_per_block=tpb))
        assert _traffic(C.hier_moments_hbm_bytes(n, itemsize, m=m, tiles_per_block=tpb)) == \
            _traffic(RC.hier_moments_hbm_bytes(n, itemsize, m=m, tiles_per_block=tpb))
        for lanes, kahan, dual in itertools.product(LANES, (False, True), (False, True)):
            kw = dict(m=m, num_cores=lanes, tiles_per_block=tpb, kahan=kahan, dual=dual)
            assert _traffic(C.hbm_bytes("fused", n, itemsize, **kw)) == _traffic(
                RC.hbm_bytes("fused", n, itemsize, **kw))
        one_lane = C.stripe_geometry(max(1, -(-n // (m * m))), tpb, 1)[1] == 1
        if one_lane:
            kw = dict(m=m, tiles_per_block=tpb, epilogue=True)
            assert _traffic(C.fused_hbm_bytes(n, itemsize, **kw)) == _traffic(
                RC.fused_hbm_bytes(n, itemsize, **kw))


def test_epilogue_model_refuses_what_the_reference_refuses():
    for fn in (C.fused_hbm_bytes, RC.fused_hbm_bytes):
        with pytest.raises(ValueError):
            fn(2**20, 4, num_cores=4, epilogue=True)
    for model in (C, RC):  # an unknown path
        with pytest.raises(ValueError):
            model.hbm_bytes("segmented_staged", 10, 4)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("tpb", TPBS)
def test_scan_and_segmented_mma_models_match_reference(lanes, tpb):
    for n, m in itertools.product(NS, (16, 128)):
        got, want = C.scan_mma_ops(n, m, lanes, tpb), RC.scan_mma_ops(n, m, lanes, tpb)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.total, got.critical_path) == (want.total, want.critical_path)
    for n, tiles, flushes, worst in ((1, 1, 1, None), (2**20, 80, 9, 3), (2**28, 18432, 2100,
                                                                            None)):
        got = C.segmented_mma_ops(n, tiles, flushes, 128, lanes, worst)
        want = RC.segmented_mma_ops(n, tiles, flushes, 128, lanes, worst)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.total, got.critical_path) == (want.total, want.critical_path)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_multi_reduce_and_scan_hbm_models_match_reference(lanes, itemsize):
    for n, m, tpb in itertools.product(NS, (16, 128), TPBS):
        for path in ("scan", "scan_staged"):
            kw = dict(m=m, num_cores=lanes, tiles_per_block=tpb)
            assert _traffic(C.hbm_bytes(path, n, itemsize, **kw)) == _traffic(
                RC.hbm_bytes(path, n, itemsize, **kw)), (path, n)
        assert _traffic(C.scan_hbm_bytes(n, itemsize, out_itemsize=4, m=m, num_cores=lanes,
                                         tiles_per_block=tpb)) == _traffic(
            RC.scan_hbm_bytes(n, itemsize, out_itemsize=4, m=m, num_cores=lanes,
                              tiles_per_block=tpb))
    for n, segments, tiles, census in ((100, 1, 1, 0), (2**20, 30, 70, 30),
                                       (2**28, 2048, 18432, 0), (2**28 + 9, 4096, 18433, 2048)):
        fetched = n + 3 * 16384
        kw = dict(segments=segments, tiles=tiles, num_cores=lanes, census=census)
        assert _traffic(C.hbm_bytes("segmented", n, itemsize, fetched_elems=fetched, **kw)) == \
            _traffic(RC.hbm_bytes("segmented", n, itemsize, fetched_elems=fetched, **kw))
        assert _traffic(C.hbm_bytes("parts", n, itemsize, segments=segments, census=census)) == \
            _traffic(RC.hbm_bytes("parts", n, itemsize, segments=segments, census=census))
        assert _traffic(C.segmented_hbm_bytes(fetched, itemsize, segments=segments, tiles=tiles,
                                              num_cores=lanes)) == _traffic(
            RC.segmented_hbm_bytes(fetched, itemsize, segments=segments, tiles=tiles,
                                   num_cores=lanes))
        assert _traffic(C.parts_hbm_bytes(n * itemsize, segments=segments)) == _traffic(
            RC.parts_hbm_bytes(n * itemsize, segments=segments))


@pytest.mark.parametrize("block", [1, 100, 4096, 16384, 16385, 40000])
def test_blocked_hier_model_counts_staging_and_levels(block):
    # one launch per level over nblk blocks, each padded to whole tiles
    n = 3 * 16384 + 5
    t = C.blocked_hier_hbm_bytes(n, 2, block)
    nblk = -(-n // block)
    kb = -(-block // 16384)
    assert t.stage_read >= n * 2 and t.stage_write >= nblk * kb * 16384 * 4
    assert t.kernel_read >= nblk * kb * 16384 * 4
    assert t.combine_read == nblk * 4
    if block <= 16384:
        r = min(8, nblk)
        assert t.kernel_write == -(-nblk // r) * r * 4
        assert t.stage_read == n * 2


class _FakeLibrary:
    """Records the grid each fused entry point is launched with."""

    def __init__(self):
        self.calls = []
        self.scratch = []  # (kernel, lanes, the lane-partials pointer)

    def fr_sum(self, x, n, dt, cd, pro, census, block_elems, blocks, lanes, *rest):
        self.calls.append(("K1", n, block_elems // ops.TILE, blocks, lanes, None))
        self.scratch.append(("K1", lanes, rest[6]))
        return 0

    def fr_moments(self, x, n, dt, cd, block_elems, blocks, lanes, *rest):
        self.calls.append(("K2", n, block_elems // ops.TILE, blocks, lanes, None))
        self.scratch.append(("K2", lanes, rest[2]))
        return 0

    def fk_sum(self, x, n, dt, cd, pro, r, blocks, bpl, lanes, *rest):
        self.calls.append(("K3", n, r, blocks, lanes, bpl))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel wrappers' launch path on CPU tensors, with the library
    replaced by a recorder: what reaches the C entry points is checked,
    nothing runs."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ops.common, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("n", [1, 2048, 131072, 131073, 40 * 131072 + 17])
@pytest.mark.parametrize("lanes", [1, 528])
def test_one_lane_launch_takes_no_lane_partials(fake_launch, n, lanes):
    """K1 and K2 on a one-lane stripe write their total from the one CTA:
    the wrappers allocate no lane partials and pass a null pointer; with
    more lanes, a buffer of 2 C words."""
    x = torch.zeros(n, dtype=torch.bfloat16)
    ops.mma_sum_fused(x, num_lanes=lanes)
    ops.mma_moments_fused(x, num_lanes=lanes)
    c = ops.lane_geometry(n, lanes)[1]
    assert [(k, got_c) for k, got_c, _ in fake_launch.scratch] == [("K1", c), ("K2", c)]
    for _, _, ptr in fake_launch.scratch:
        assert (ptr is None) == (c == 1) and (ptr is None or ptr != 0)


@pytest.mark.parametrize("n", [1, 16385, 8 * 16384, 40 * 131072 + 17, 2**22 + 3])
@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("tpb", [1, 8])
def test_kernel_grids_match_cost_model(fake_launch, n, lanes, tpb):
    x = torch.zeros(n, dtype=torch.bfloat16)
    ops.mma_sum_fused(x, num_lanes=lanes, tiles_per_block=tpb)
    ops.mma_moments_fused(x, num_lanes=lanes, tiles_per_block=tpb)
    ops.mma_sum_kahan(x, num_lanes=lanes, tiles_per_block=tpb)
    tiles = max(1, -(-n // 16384))
    r, c, bpl, tpad = C.stripe_geometry(tiles, tpb, lanes)
    assert RC.stripe_geometry(tiles, tpb, lanes) == (r, c, bpl, tpad)
    assert [k for k, *_ in fake_launch.calls] == ["K1", "K2", "K3"]
    for kernel, got_n, got_r, blocks, got_c, got_bpl in fake_launch.calls:
        assert (got_n, got_r, got_c) == (n, r, c), kernel
        assert blocks == -(-tiles // r) and blocks <= c * bpl and (blocks > c * (bpl - 1))
        if got_bpl is not None:
            assert got_bpl == bpl
    assert ops.lane_geometry(n, lanes, tpb) == (r, c, bpl, tpad)
    assert np.isfinite(tpad)
