"""Port parity for the segmented gather (K8): the cover and flush maps of
``repro_torch.kernels.mma_reduce`` against the reference's arrays, and
``mma_sum_segments`` (its plain version, as the wrapper runs on CPU
tensors) against ``mma_sum_segments_pallas`` in interpret mode, on the same
seeded numpy buffers: every prologue, moments, census and an epilogue, at
1, 2 and 3 lanes; the empty middle segment's epilogue at every lane count;
the trace against the reference's and the cost model; and the arguments
that reach the kernel's C entry point (a recording fake library).

Tolerance: ``tests/harness.py``'s ``mass_tol`` at the compute dtype's
``COMPUTE_REL`` per unit of each segment's mass (|x|, or x^2 for square
and moments) -- both sides round each element to the compute dtype and sum
in f32 in other orders. Maps, traces and census counts are exact. Buffers
hold at most nine 16384-element tiles (interpret mode runs one grid step
per tile).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import COMPUTE_REL, assert_bits_equal
from repro.kernels.mma_reduce import ops as RO
from repro_torch.core import cost_model
from repro_torch.kernels import build
from repro_torch.kernels.mma_reduce import ops

T = 16384

# offsets: an empty segment first, in the middle and last; boundaries on
# and off the tile grid; one segment inside a tile; one over three tiles
OFFSETS = {
    "ragged": (0, 0, 100, 20000, 20000, 3 * T + 5, 3 * T + 7, 5 * T, 9 * T - 3, 9 * T - 3),
    "aligned": (0, T, T, 4 * T, 6 * T),
    "one": (0, 2 * T + 11),
}


def _buffer(n, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(n) * 2 + 0.3).astype(dtype)


def _seg_mass(x, offsets, square):
    v = x.astype(np.float64)
    v = v * v if square else np.abs(v)
    return np.array([v[a:b].sum() for a, b in zip(offsets[:-1], offsets[1:])])


@pytest.mark.parametrize("name", sorted(OFFSETS))
@pytest.mark.parametrize("lanes", [1, 2, 3, 5])
@pytest.mark.parametrize("tpb", [1, 3])
def test_cover_and_flush_maps_match_reference(name, lanes, tpb):
    offsets = OFFSETS[name]
    got = ops.segment_cover_layout(offsets, T)
    want = RO.segment_cover_layout(offsets, T)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for g, w in zip(ops.segment_tile_layout(offsets, T), RO.segment_tile_layout(offsets, T)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    seg_of = want[2]
    np.testing.assert_array_equal(ops.lane_flush_map(seg_of, tpb, lanes),
                                  RO.lane_flush_map(seg_of, tpb, lanes))
    assert ops._cover_fetched_elems(want[1], offsets[-1], T) == RO._cover_fetched_elems(
        want[1], offsets[-1], T)


def test_flush_map_on_random_segment_maps():
    rng = np.random.default_rng(1)
    for t in (1, 7, 40, 129):
        seg_of = np.sort(rng.integers(0, 9, size=t)).astype(np.int32)
        for tpb, lanes in ((1, 1), (1, 4), (2, 3), (5, 2), (1, 200)):
            np.testing.assert_array_equal(ops.lane_flush_map(seg_of, tpb, lanes),
                                          RO.lane_flush_map(seg_of, tpb, lanes))


CASES = [  # prologue, census, epilogue
    ("identity", False, ()),
    ("square", False, ()),
    ("abs", False, ()),
    ("moments", False, ()),
    ("identity", True, ()),
    ("square", True, (("add_eps", 1.0), ("sqrt",))),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{'-census' if c[1] else ''}"
                         f"{'-chain' if c[2] else ''}")
@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_segments_match_pallas(case, lanes, cd):
    prologue, census, chain = case
    offsets = OFFSETS["ragged"]
    x = _buffer(offsets[-1], seed=lanes)
    if census:  # NaN and Inf in two segments, one of them at a shared block
        x[150] = np.nan
        x[3 * T + 6] = np.inf
        x[3 * T + 4] = -np.inf
    want = np.asarray(RO.mma_sum_segments_pallas(
        jnp.asarray(x), offsets, num_cores=lanes, compute_dtype=cd, prologue=prologue,
        epilogue=chain, census=census, interpret=True))
    got = ops.mma_sum_segments(torch.from_numpy(x), offsets, compute_dtype=getattr(torch, cd),
                               prologue=prologue, epilogue=chain, census=census,
                               num_lanes=lanes).numpy()
    nseg = len(offsets) - 1
    assert got.shape == want.shape == ((2 * nseg,) if (census or prologue == "moments")
                                       else (nseg,))
    finite = np.where(np.isfinite(x), x, 0)
    mass = _seg_mass(finite, offsets, prologue in ("square", "moments"))
    tol = COMPUTE_REL[cd] * np.maximum(mass, 1.0)
    if prologue == "moments":
        np.testing.assert_array_less(np.abs(got[:nseg] - want[:nseg]),
                                     COMPUTE_REL[cd] * np.maximum(
                                         _seg_mass(x, offsets, False), 1.0) + 1e-6)
        np.testing.assert_array_less(np.abs(got[nseg:] - want[nseg:]), tol + 1e-6)
        return
    if census:  # counts exact; the poisoned sums both non-finite
        np.testing.assert_array_equal(got[nseg:], want[nseg:])
        assert got[nseg:].sum() == 3
        bad = ~np.isfinite(want[:nseg])
        np.testing.assert_array_equal(~np.isfinite(got[:nseg]), bad)
        got, want, tol = got[:nseg][~bad], want[:nseg][~bad], tol[~bad]
    if chain:  # d sqrt(t + 1) = dt / (2 sqrt(t + 1))
        tol = tol / (2 * np.sqrt(mass[~bad] + 1.0) if census else 2 * np.sqrt(mass + 1.0))
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-6)


def test_empty_middle_segment_epilogue_is_lane_invariant_bitwise():
    """An empty segment's slot is the chain of 0 at every lane count, as the
    reference patches it after its one-lane launches."""
    offsets = (0, 3000, 3000, 2 * T + 9, 2 * T + 9)
    x = _buffer(offsets[-1], seed=4)
    chain = (("add_eps", 2.5), ("scale", 3.0))
    outs = [ops.mma_sum_segments(torch.from_numpy(x), offsets, epilogue=chain,
                                 num_lanes=lanes).numpy() for lanes in (1, 2, 3, 4)]
    for out in outs:
        assert_bits_equal(out[[1, 3]], np.float32([7.5, 7.5]))
        assert_bits_equal(out[[1, 3]], outs[0][[1, 3]])
    want = np.asarray(RO.mma_sum_segments_pallas(jnp.asarray(x), offsets, epilogue=chain,
                                                 interpret=True))
    assert_bits_equal(want[[1, 3]], outs[0][[1, 3]])
    # every segment empty: the chain of 0 everywhere, census counts 0
    empty = ops.mma_sum_segments(torch.zeros(5), (0, 0, 0), epilogue=chain, census=True)
    np.testing.assert_array_equal(empty.numpy(), [7.5, 7.5, 0.0, 0.0])


def test_lane_fold_is_in_lane_order():
    sub = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32))
    want = ((sub[0] + sub[1]) + sub[2]) + sub[3]
    assert torch.equal(ops.combine_segment_partials(sub), want)
    assert torch.equal(ops.combine_segment_partials(sub[:1]), sub[0])
    # only the lanes that streamed a tile of a segment fold, in lane order
    # (tile t is lane t mod C's): segments over tiles [0, 2), [2, 7), none
    seg_of = np.array([0, 0, 1, 1, 1, 1, 1])
    touched = ops.segment_lanes(seg_of, 3, 4)
    np.testing.assert_array_equal(touched, [[1, 1, 0], [1, 1, 0], [0, 1, 0], [0, 1, 0]])
    got = ops.combine_segment_partials(sub[:, :3], touched)
    assert torch.equal(got[0], sub[0, 0] + sub[1, 0])
    assert torch.equal(got[1], ((sub[0, 1] + sub[1, 1]) + sub[2, 1]) + sub[3, 1])
    assert float(got[2]) == 0.0


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("dual", [False, True])
def test_segmented_trace_matches_reference(lanes, dual):
    offsets = OFFSETS["ragged"]
    x = _buffer(offsets[-1], seed=7).astype(np.float32)
    rtr, tr = [], []
    pro = "moments" if dual else "identity"
    RO.mma_sum_segments_pallas(jnp.asarray(x).astype(jnp.bfloat16), offsets, num_cores=lanes,
                               prologue=pro, trace=rtr, interpret=True)
    ops.mma_sum_segments(torch.from_numpy(x).to(torch.bfloat16), offsets, prologue=pro,
                         num_lanes=lanes, trace=tr)
    for field in ("n", "m", "levels", "mma_ops", "num_cores", "lane_mma_ops",
                  "combine_mma_ops", "hbm_bytes", "census"):
        assert getattr(tr[0], field) == getattr(rtr[0], field), field


class _FakeLibrary:
    """Records what reaches the gather kernel's C entry point."""

    def __init__(self):
        self.calls = []

    def sg_segments(self, x, n, dt, cd, pro, census, maps, tpad, lanes, nseg, aligned, *rest):
        self.calls.append(dict(n=n, dtype=dt, compute=cd, prologue=pro, census=census,
                               tpad=tpad, lanes=lanes, nseg=nseg, steps=rest[0]))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(ops.common, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("name", sorted(OFFSETS))
def test_gather_launch_bytes_match_cost_model(fake_launch, lanes, name):
    """One launch; the bytes handed to and written by it (the cover's
    blocks, five (tpad,) maps, the (C, S) sub-partials) equal the model's
    launch IO, a straddled block counted once per neighbour."""
    offsets = OFFSETS[name]
    x = torch.zeros(offsets[-1], dtype=torch.bfloat16)
    tr = []
    before = ops.mma_sum_segments.launches
    ops.mma_sum_segments(x, offsets, num_lanes=lanes, census=True, trace=tr,
                         epilogue=("sqrt",))
    assert ops.mma_sum_segments.launches == before + 1
    (call,) = fake_launch.calls
    _, src, seg, lo, hi = ops.segment_cover_layout(offsets, T)
    t = src.size
    _, c, tpl, tpad = cost_model.stripe_geometry(t, 1, lanes)
    nseg = len(offsets) - 1
    assert call == dict(n=offsets[-1], dtype=1, compute=1, prologue=0, census=1, tpad=tpad,
                        lanes=c, nseg=nseg, steps=1)
    fetched = ops._cover_fetched_elems(src, offsets[-1], T)
    model = cost_model.segmented_hbm_bytes(fetched, 2, segments=2 * nseg, tiles=t,
                                           num_cores=lanes)
    assert tr[0].launch_io_bytes == model.launch_io
    assert fetched >= offsets[-1] and fetched - offsets[-1] < nseg * T
