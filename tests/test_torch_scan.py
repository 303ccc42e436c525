"""Port parity for the prefix sums: the scan kernel K9 (``mma_scan``; its
plain version, as the wrapper runs on CPU tensors) against the reference's
``mma_scan_pallas`` in interpret mode, ``mma_scan_torch`` against
``mma_scan_jnp``, ``repro_torch.scan`` against ``repro.scan`` (axis,
reverse, integers, gradients against ``jax.grad``), the scan plans,
traces and launch bytes against the reference and the cost model, and
``packing_offsets``.

Tolerance: ``tests/harness.py``'s ``scan_budget`` -- per element, the
compute dtype's ``COMPUTE_REL`` times the running absolute mass of the
prefix -- against the reference's output on the same operand. The port's
own contracts are bitwise: its kernel output is the same at every lane
count, and its exclusive scan is its inclusive scan shifted by one.
Operands hold at most ten 16384-element tiles.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from harness import assert_bits_equal, scan_budget
from repro import reduce as RR
from repro.core import cost_model as RC
from repro.data.pipeline import packing_offsets as ref_packing_offsets
from repro.kernels import scan as RS
from repro_torch import reduce as R
from repro_torch.core import cost_model
from repro_torch.data import packing_offsets
from repro_torch.kernels import build
from repro_torch.kernels.scan import ops

T = 16384


def _x(n, seed=0, dtype=np.float32, shape=None):
    x = (np.random.default_rng(seed).standard_normal(n) * 2 + 0.3).astype(np.float32)
    return x.reshape(shape) if shape else x.astype(dtype)


def _pair(x, dtype):
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("n", [5000, 3 * T + 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("lanes", [1, 2])
def test_mma_scan_matches_pallas(n, dtype, inclusive, lanes):
    xj, xt = _pair(_x(n, seed=n % 5), dtype)
    want = np.asarray(RS.mma_scan_pallas(xj, inclusive=inclusive, tiles_per_block=1,
                                         num_cores=lanes, interpret=True), np.float64)
    got = ops.mma_scan(xt, inclusive=inclusive, tiles_per_block=1, num_lanes=lanes)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = scan_budget(np.asarray(xj, np.float32), dtype)
    np.testing.assert_array_less(np.abs(got.float().numpy() - want), tol)


@pytest.mark.parametrize("shape", [(3, 700), (2, 2, 300), (1000,)])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_mma_scan_torch_matches_jnp(shape, inclusive, cd):
    x = _x(int(np.prod(shape)), seed=3, shape=shape)
    want = np.asarray(RS.mma_scan_jnp(jnp.asarray(x), inclusive=inclusive, compute_dtype=cd),
                      np.float64)
    got = ops.mma_scan_torch(torch.from_numpy(x), inclusive=inclusive,
                             compute_dtype=getattr(torch, cd) if cd else None)
    assert got.dtype == torch.float32 and got.shape == shape
    tol = scan_budget(x, cd or "float32")
    np.testing.assert_array_less(np.abs(got.numpy() - want), tol)
    if not inclusive:
        assert np.all(got.numpy()[..., 0] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inclusive", [True, False])
def test_mma_scan_is_bitwise_the_same_at_every_lane_count(dtype, inclusive):
    _, xt = _pair(_x(9 * T + 3, seed=11), dtype)
    outs = [ops.mma_scan(xt, inclusive=inclusive, tiles_per_block=1, num_lanes=c)
            for c in (1, 2, 4, 8)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_scan_exclusive_is_exact_shift(cd):
    xt = torch.from_numpy(_x(3 * T + 100, seed=5))
    inc = ops.mma_scan(xt, compute_dtype=cd)
    exc = ops.mma_scan(xt, inclusive=False, compute_dtype=cd)
    assert float(exc[0]) == 0.0
    assert_bits_equal(exc[1:].numpy(), inc[:-1].numpy())
    for backend in ("torch", "mma_torch"):
        out = R.scan(xt[:5000], inclusive=False, backend=backend)
        assert float(out[0]) == 0.0
    # the torch route shifts the inclusive scan exactly
    assert_bits_equal(R.scan(xt, inclusive=False, backend="torch")[1:].numpy(),
                      R.scan(xt, backend="torch")[:-1].numpy())


def test_mma_scan_plain_f32_is_the_row_prefix_chain():
    """At f32 compute the plain version is the kernel's order: each row
    summed left to right, the rows' totals folded left to right, the tile
    totals folded left to right into the carry."""
    x = torch.from_numpy(_x(2 * T, seed=8))
    out = ops.mma_scan_plain(x, compute_dtype=torch.float32)
    tiles = x.view(2, 128, 128)
    rowpref = torch.zeros(2, 128, 128)
    acc = torch.zeros(2, 128)
    for j in range(128):
        acc = acc + tiles[:, :, j]
        rowpref[:, :, j] = acc
    down = torch.zeros(2, 128)
    d = torch.zeros(2)
    for i in range(128):
        down[:, i] = d
        d = d + rowpref[:, i, 127]
    totals = down[:, 127] + rowpref[:, 127, 127]
    carry = torch.stack([torch.zeros(()), torch.zeros(()) + totals[0]])
    want = (rowpref + down[:, :, None]) + carry[:, None, None]
    assert torch.equal(out, want.reshape(-1))


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("mma_torch", "mma_jnp"),
                                                 ("cuda_fused", "pallas_fused")])
def test_scan_axis_reverse_and_integers_match_reference(backend, ref_backend):
    x = _x(3 * 700, seed=2, shape=(3, 700))
    for axis, reverse, inclusive in ((0, False, True), (-1, True, True), (1, True, False)):
        want = np.asarray(repro.scan(jnp.asarray(x), axis=axis, reverse=reverse,
                                     inclusive=inclusive, backend=ref_backend), np.float64)
        got = R.scan(torch.from_numpy(x), axis=axis, reverse=reverse, inclusive=inclusive,
                     backend=backend)
        assert got.shape == x.shape and got.dtype == torch.float32
        moved = np.moveaxis(x, axis, -1)
        tol = scan_budget(moved[..., ::-1] if reverse else moved, "float32")
        tol = np.moveaxis(tol[..., ::-1] if reverse else tol, -1, axis)
        np.testing.assert_array_less(np.abs(got.numpy() - want), tol)
    big = np.full((3,), 2**24, np.int32)
    want = np.asarray(repro.scan(jnp.asarray(big)))
    got = R.scan(torch.from_numpy(big))  # auto: the exact integer route
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [2**24, 2**25, 3 * 2**24])
    # a 1-D float stream on a kernel backend: one kernel (plain version here)
    one = _x(3 * T + 9, seed=6)
    want = np.asarray(repro.scan(jnp.asarray(one), backend=ref_backend), np.float64)
    got = R.scan(torch.from_numpy(one), backend=backend)
    np.testing.assert_array_less(np.abs(got.numpy() - want), scan_budget(one, "float32"))


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("mma_torch", "mma_jnp"),
                                                 ("cuda_fused", "pallas_fused"),
                                                 ("cuda_hier", "pallas_hier")])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_gradient_matches_jax_grad(backend, ref_backend, inclusive, reverse):
    x = _x(2 * T + 77, seed=9)
    w = _x(2 * T + 77, seed=10)

    def loss(v):
        return jnp.sum(jnp.asarray(w) * repro.scan(v, inclusive=inclusive, reverse=reverse,
                                                   backend=ref_backend))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)), np.float64)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = R.scan(xt, inclusive=inclusive, reverse=reverse, backend=backend)
    (got,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), xt)
    # the cotangent is a (reversed) scan of w: its budget
    tol = scan_budget(w, "float32", reverse=not reverse)
    np.testing.assert_array_less(np.abs(got.numpy() - want), tol)


def test_scan_plans_route_as_the_reference():
    for shape, dtype, tdtype in (((1000,), jnp.int32, torch.int32),
                                 ((8,), jnp.float32, torch.float32),
                                 ((64, 4096), jnp.float32, torch.float32),
                                 ((200_000,), jnp.bfloat16, torch.bfloat16),
                                 ((200_000,), jnp.float32, torch.float32),
                                 ((200_000,), jnp.int32, torch.int32)):
        want = RR.scan_plan_for(shape, dtype)
        got = R.scan_plan_for(shape, tdtype)
        names = {"xla": "torch", "mma_jnp": "mma_torch", "pallas_fused": "cuda_fused"}
        assert got.backend == names[want.backend], shape
        assert got.compute_dtype == want.compute_dtype
        assert (got.m, got.tiles_per_block) == (want.m, want.tiles_per_block)
    # on a CUDA device a long 1-D float stream takes the kernel; batched not
    assert R.scan_plan_for((200_000,), torch.float32, device="cuda").backend == "cuda_fused"
    assert R.scan_plan_for((64, 4096), torch.float32, device="cuda").backend == "mma_torch"
    assert R.scan_plan_for((200_000,), torch.int32, device="cuda").backend == "torch"
    assert R.scan_plan_for((200_000,), torch.float32, device="cuda").num_lanes == 1
    R.quarantine_backend("cuda_fused")
    try:
        assert R.scan_plan_for((200_000,), torch.float32, device="cuda").backend == "mma_torch"
    finally:
        R.reinstate_backend("cuda_fused")
    plan = R.scan_plan_for((10,), torch.float32, backend="cuda_fused", num_lanes=3)
    assert plan.replace(num_lanes=1).num_lanes == 1
    with pytest.raises(ValueError):
        R.ScanPlan(num_lanes=0)
    with pytest.raises(ValueError):
        R.scan(torch.ones(3), kind="cumprod")


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("dtype,itemsize", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_scan_trace_and_plan_bytes_match_the_models(lanes, dtype, itemsize):
    n = 300_000
    rtr, tr = [], []
    RS.mma_scan_pallas(jnp.zeros((n,), jnp.float32), tiles_per_block=2, num_cores=lanes,
                       trace=rtr, interpret=True)
    ops.mma_scan(torch.zeros(n), tiles_per_block=2, num_lanes=lanes, trace=tr)
    for field in ("n", "m", "inclusive", "fallback"):
        assert getattr(tr[0], field) == getattr(rtr[0], field), field
    # the reference's trace reads the striped models, which the port keeps
    # equal; the port's trace reads its own kernel's bytes
    ops_model = cost_model.scan_mma_ops(n, num_cores=lanes, tiles_per_block=2)
    striped = cost_model.scan_hbm_bytes(n, 4, num_cores=lanes, tiles_per_block=2)
    assert (rtr[0].mma_ops, rtr[0].lane_mma_ops, rtr[0].carry_mma_ops, rtr[0].hbm_bytes) == \
        (ops_model.total, ops_model.lane_scan, ops_model.carry_worst, striped.total)
    assert tr[0].hbm_bytes == cost_model.lookback_scan_hbm_bytes(n, 4).total
    plan = R.scan_plan_for((n,), dtype, backend="cuda_fused", num_lanes=lanes)
    ref_plan = RR.scan_plan_for((n,), jnp.bfloat16 if itemsize == 2 else jnp.float32,
                                backend="pallas_fused", num_cores=lanes)
    got, want = plan.hbm_bytes(n, dtype), ref_plan.hbm_bytes(n, ref_plan.compute_dtype)
    assert (got.launch_io, got.total) == (want.launch_io, want.total)


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def sc_scan(self, x, n, dt, cd, inclusive, aligned, out, state, epoch, stream):
        self.calls.append((n, dt, cd, inclusive, epoch))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(ops.common, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("n", [1, T + 1, 9 * T + 3, 40 * 131072 + 17])
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_scan_launch_matches_geometry_and_bytes(fake_launch, n, lanes):
    x = torch.zeros(n, dtype=torch.bfloat16)
    tr = []
    before = ops.mma_scan.launches
    ops.mma_scan(x, inclusive=False, num_lanes=lanes, trace=tr)
    ops.mma_scan(x, inclusive=True, num_lanes=lanes)
    assert ops.mma_scan.launches == before + 2
    # one launch whatever the lane count, each under a fresh look-back epoch
    (n0, dt, cd, inc, e0), (n1, _, _, inc1, e1) = fake_launch.calls
    assert (n0, dt, cd, inc, n1, inc1) == (n, 1, 1, 0, n, 1) and e1 == e0 + 1 >= 2
    own = cost_model.lookback_scan_hbm_bytes(n, 2)
    assert tr[0].launch_io_bytes == own.launch_io
    assert own.refetch_read == 0 and tr[0].hbm_bytes == own.total
    model = cost_model.scan_hbm_bytes(n, 2, num_cores=lanes)
    assert model.refetch_read == RC.scan_hbm_bytes(n, 2, num_cores=lanes).refetch_read


@pytest.mark.parametrize("backend,ref_backend", [(None, None), ("cuda_fused", "pallas_fused"),
                                                 ("mma_torch", "mma_jnp"), ("torch", "xla")])
def test_packing_offsets_match_reference(backend, ref_backend):
    lengths = np.random.default_rng(12).integers(0, 3000, size=300).astype(np.int32)
    lengths[[5, 6, 150]] = 0
    want = np.asarray(ref_packing_offsets(jnp.asarray(lengths), backend=ref_backend))
    got = packing_offsets(torch.from_numpy(lengths), backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1:], np.cumsum(lengths.astype(np.int64)))
    with pytest.raises(ValueError):
        packing_offsets(torch.ones((2, 2), dtype=torch.int32))


# ------------------- the kernel's look-back, emulated ------------------------


def _look_back(status, value, t, lanes, windows, prog):
    """One attempt of tile t's look-back, as csrc/scan.cu's warp runs it
    with ``lanes`` lanes and room for ``windows`` windows of words: read the
    words of t-1-lanes*w-i (lane i; before tile 0 an inclusive 0); wait
    unless every word before the nearest inclusive carry is published;
    keep a window of totals and read the next; start again from t-1 when
    the room runs out. Returns c[t], or None while it waits."""
    w, held = prog.setdefault(t, [0, []])
    j = t - 1 - lanes * w - np.arange(lanes)
    st = np.where(j < 0, 2, status[np.maximum(j, 0)])
    val = np.where(j < 0, np.float32(0), value[np.maximum(j, 0)]).astype(np.float32)
    incl = np.flatnonzero(st == 2)
    first = incl[0] if incl.size else lanes
    if np.any(st[:first] == 0):
        return None
    held = held + list(val[:first])
    if not incl.size:
        prog[t] = [w + 1, held] if w + 1 < windows else [0, []]
        return None
    c = val[first]
    for q in range(len(held) - 1, -1, -1):  # tiles k+1 .. t-1, left to right
        c = np.float32(c + held[q])
    del prog[t]
    return c


def lookback_carries(totals, seed, lanes=4, windows=2):
    """Every tile's carry as the kernel's CTAs find it, the events drawn in
    a random order: a CTA takes the next ticket; a started tile publishes
    its total (tile 0 its inclusive carry 0 + total[0] at once); a tile
    with its total out tries its look-back and, once it has c[t],
    publishes c[t] + total[t]."""
    rng = np.random.default_rng(seed)
    n = len(totals)
    status = np.zeros(n, np.int8)  # 0 unpublished, 1 total, 2 inclusive carry
    value = np.zeros(n, np.float32)
    carry = np.full(n, np.nan, np.float32)
    computing, waiting, prog, ticket = [], [], {}, 0
    while ticket < n or computing or waiting:
        pick = rng.integers(3)
        if (pick == 0 or not (computing or waiting)) and ticket < n:
            computing.append(ticket)
            ticket += 1
        elif (pick == 1 or not waiting) and computing:
            t = computing.pop(rng.integers(len(computing)))
            if t == 0:
                status[0], value[0], carry[0] = 2, np.float32(0) + totals[0], 0
            else:
                status[t], value[t] = 1, totals[t]
                waiting.append(t)
        elif waiting:
            t = waiting[rng.integers(len(waiting))]
            c = _look_back(status, value, t, lanes, windows, prog)
            if c is not None:
                carry[t], status[t], value[t] = c, 2, np.float32(c + totals[t])
                waiting.remove(t)
    return carry


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tiles,lanes,windows", [(1, 4, 2), (2, 4, 2), (37, 4, 2),
                                                 (300, 8, 3), (2000, 32, 16)])
def test_lookback_carries_are_the_left_fold_bitwise(seed, tiles, lanes, windows):
    # totals across six decades, so that another order of the adds shows
    rng = np.random.default_rng(100 + seed)
    totals = (rng.standard_normal(tiles) * 10.0 ** rng.uniform(-3, 3, tiles)).astype(np.float32)
    got = lookback_carries(totals, seed, lanes, windows)
    want = np.cumsum(np.concatenate([np.zeros(1, np.float32), totals]), dtype=np.float32)[:-1]
    assert_bits_equal(got, want)
    assert_bits_equal(got, ops.carry_chain(torch.from_numpy(totals)).numpy())


@pytest.mark.parametrize("n", [1, 100, T, T + 1, 3 * T + 5, 9 * T + 3])
@pytest.mark.parametrize("dtype,cd", [(torch.float32, None), (torch.bfloat16, None),
                                      (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("inclusive", [True, False])
def test_lookback_scan_is_the_plain_version_bitwise(n, dtype, cd, inclusive):
    x = torch.from_numpy(_x(n, seed=n % 7)).to(dtype)
    r, down, totals = ops.scan_tile_parts(x, inclusive, cd)
    assert r.shape[0] == max(1, -(-n // T))
    for seed in range(3):
        carry = torch.from_numpy(lookback_carries(totals.numpy(), seed, lanes=2, windows=2))
        got = ops.scan_from_parts(r, down, carry, dtype)
        assert_bits_equal(got.float().numpy(),
                          ops.mma_scan_plain(x, inclusive, cd).float().numpy())
    assert_bits_equal(ops.mma_scan(x, inclusive=inclusive, compute_dtype=cd).float().numpy(),
                      got[:n].float().numpy())
