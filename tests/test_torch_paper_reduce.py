"""Port parity for the paper's reduction engine: the level kernel K10
(``tile_partials``, ``mma_sum_hier``, ``mma_moments_hier``) against the
reference's ``reduce_tiles`` and hierarchical ``mma_sum_pallas`` in
interpret mode; the moments kernel K2 and the Kahan kernel K3 (their plain
versions, as every wrapper runs on CPU tensors) against ``pallas_fused``
and the f64 oracle; ``mma_sum(trace=)``, ``classic_tree_sum`` and
``core.precision`` against ``repro.core``.

Tolerance: ``tests/harness.py``'s ``COMPUTE_REL`` per unit of the mass a
partial accumulates, at the compute dtype -- the row sums of a tile are
rounded to that dtype before the second MMA, and the two sides sum each
row in another order, so a rounding may flip. Traces are integer
bookkeeping and must be equal. Inputs are seeded numpy, n <= 2^17.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import COMPUTE_REL, budget_for, oracle
from repro.core import mma_reduce as RM
from repro.core import precision as RP
from repro.kernels.mma_reduce import kernel as RK
from repro.kernels.mma_reduce import ops as RO
from repro_torch.core import cost_model
from repro_torch.core import mma_reduce as M
from repro_torch.core import precision as P
from repro_torch.kernels.mma_reduce import ops

T = 16384
DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]


def _x(n, seed=0, scale=2.0, shift=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale + shift).astype(np.float32)


def _tile_mass(x, prologue, t):
    """Per tile, the mass its partial accumulates: sum of |x| or of x^2."""
    v = x.astype(np.float64)
    v = v * v if prologue in ("square", "moments") else np.abs(v)
    return np.pad(v, (0, t * T - x.size)).reshape(t, T).sum(-1)


@pytest.mark.parametrize("n", [1, 5000, 3 * T + 5, 8 * T + 77])
@pytest.mark.parametrize("prologue", ["identity", "square", "abs", "moments"])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_tile_partials_match_reduce_tiles(n, prologue, cd):
    x = _x(n, seed=n % 7)
    want = np.asarray(RK.reduce_tiles(jnp.asarray(x), compute_dtype=cd[0], prologue=prologue,
                                      tiles_per_block=3, interpret=True))
    got = ops.tile_partials(torch.from_numpy(x), compute_dtype=cd[1], prologue=prologue,
                            tiles_per_block=3).numpy()
    assert got.shape == want.shape
    t = want.shape[0]
    tol = COMPUTE_REL[cd[0]] * _tile_mass(x, prologue, t) + 1e-6
    if prologue == "moments":
        tol_s = COMPUTE_REL[cd[0]] * _tile_mass(x, "abs", t) + 1e-6
        assert np.all(np.abs(got[:, 0] - want[:, 0]) <= tol_s)
        assert np.all(np.abs(got[:, 1] - want[:, 1]) <= tol)
    else:
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("n", [1, 777, 3 * T + 5, 5 * T])
@pytest.mark.parametrize("prologue", ["identity", "square", "abs"])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_hierarchy_matches_reference_with_trace(n, prologue, cd):
    x = _x(n, seed=1)
    rtr, tr = [], []
    want = float(RO.mma_sum_pallas(jnp.asarray(x), mode="hierarchical", compute_dtype=cd[0],
                                   prologue=prologue, trace=rtr, interpret=True))
    got = ops.mma_sum_hier(torch.from_numpy(x), compute_dtype=cd[1], prologue=prologue,
                           trace=tr)
    kind = {"identity": "sum", "square": "sumsq", "abs": "sum"}[prologue]
    v = np.abs(x) if prologue == "abs" else x
    assert abs(float(got) - want) <= budget_for(v, kind, compute_dtype=cd[0])
    assert abs(float(got) - oracle(v, kind)) <= budget_for(v, kind, compute_dtype=cd[0])
    assert (tr[0].levels, tr[0].mma_ops, tr[0].hbm_bytes, tr[0].n, tr[0].m) == (
        rtr[0].levels, rtr[0].mma_ops, rtr[0].hbm_bytes, rtr[0].n, rtr[0].m)
    assert tr[0].levels == cost_model.levels(n, 128)
    # the bytes handed to and written by the launches are the model's
    assert tr[0].launch_io_bytes == cost_model.hier_hbm_bytes(n, 4).launch_io


@pytest.mark.parametrize("n", [100, T])
def test_hierarchy_epilogue_on_the_final_level(n):
    x = _x(n, seed=2)
    chain = (("sqrt",), ("clip_coeff", 1.0, 1e-9))
    want = float(RO.mma_sum_pallas(jnp.asarray(x), mode="hierarchical", compute_dtype="float32",
                                   prologue="square", epilogue=chain, interpret=True))
    got = ops.mma_sum_hier(torch.from_numpy(x), compute_dtype=torch.float32, prologue="square",
                           epilogue=chain)
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError):  # a chain only on a final single-tile level
        ops.tile_partials(torch.from_numpy(_x(2 * T)), epilogue=chain)


@pytest.mark.parametrize("n", [1, 3 * T + 5, 7 * T + 1])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_moments_hierarchy_matches_reference(n, cd):
    x = _x(n, seed=3)
    rtr, tr = [], []
    ws, wss = RO.mma_moments_pallas(jnp.asarray(x), mode="hierarchical", compute_dtype=cd[0],
                                    trace=rtr, interpret=True)
    gs, gss = ops.mma_moments_hier(torch.from_numpy(x), compute_dtype=cd[1], trace=tr)
    assert abs(float(gs) - float(ws)) <= budget_for(x, "sum", compute_dtype=cd[0])
    assert abs(float(gss) - float(wss)) <= budget_for(x, "sumsq", compute_dtype=cd[0])
    assert (tr[0].levels, tr[0].mma_ops, tr[0].hbm_bytes) == (
        rtr[0].levels, rtr[0].mma_ops, rtr[0].hbm_bytes)
    assert tr[0].launch_io_bytes == cost_model.hier_moments_hbm_bytes(n, 4).launch_io


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_moments_kernel_matches_pallas_fused(lanes, cd):
    x = _x(6 * 8 * T // 4 + 13, seed=4)  # 13 tiles: 2 blocks, the second ragged
    rtr, tr = [], []
    ws, wss = RO.mma_moments_pallas(jnp.asarray(x), mode="fused", num_cores=lanes,
                                    tiles_per_block=4, compute_dtype=cd[0], trace=rtr,
                                    interpret=True)
    gs, gss = ops.mma_moments_fused(torch.from_numpy(x), compute_dtype=cd[1], num_lanes=lanes,
                                    tiles_per_block=4, trace=tr)
    assert abs(float(gs) - float(ws)) <= budget_for(x, "sum", compute_dtype=cd[0])
    assert abs(float(gss) - float(wss)) <= budget_for(x, "sumsq", compute_dtype=cd[0])
    s, ss = oracle(x, "moments")
    assert abs(float(gs) - s) <= budget_for(x, "sum", compute_dtype=cd[0])
    assert abs(float(gss) - ss) <= budget_for(x, "sumsq", compute_dtype=cd[0])
    assert (tr[0].mma_ops, tr[0].lane_mma_ops, tr[0].combine_mma_ops, tr[0].hbm_bytes,
            tr[0].num_cores) == (rtr[0].mma_ops, rtr[0].lane_mma_ops, rtr[0].combine_mma_ops,
                                 rtr[0].hbm_bytes, rtr[0].num_cores)


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("prologue", ["identity", "square", "abs"])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_kahan_kernel_against_oracle_and_pallas_native(lanes, prologue, cd):
    # held against the f64 oracle and the reference's native pass, not the
    # reference's own Kahan output (ROADMAP Queue 3)
    x = _x(13 * T + 13, seed=5)
    kind = {"identity": "sum", "square": "sumsq", "abs": "sum"}[prologue]
    v = np.abs(x) if prologue == "abs" else x
    got = float(ops.mma_sum_kahan(torch.from_numpy(x), compute_dtype=cd[1], prologue=prologue,
                                  num_lanes=lanes, tiles_per_block=2))
    native = float(RO.mma_sum_pallas(jnp.asarray(x), num_cores=lanes, tiles_per_block=2,
                                     compute_dtype=cd[0], prologue=prologue, interpret=True))
    tol = budget_for(v, kind, compute_dtype=cd[0])
    assert abs(got - oracle(v, kind)) <= tol
    assert abs(got - native) <= tol
    again = ops.mma_sum_fused(torch.from_numpy(x), compute_dtype=cd[1], prologue=prologue,
                              num_lanes=lanes, tiles_per_block=2, kahan=True)
    assert float(again) == got


def _carry_input(seed=6, big=1e4):
    """Tile 0 at +big, tiles 1-6 near 1 (one-sided noise), tile 7 at -big:
    the small tiles' row sums are added to rows that already hold 128 *
    big, so an uncompensated carry drops their low bits."""
    rng = np.random.default_rng(seed)
    x = np.empty(8 * T, np.float32)
    x[:T], x[7 * T:] = big, -big
    x[T:7 * T] = 1.0 + rng.random(6 * T) * 1e-3
    return x


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_kahan_error_at_most_native_on_carry_dominated_input(lanes):
    x = _carry_input()
    exact = x.astype(np.float64).sum()
    kw = dict(compute_dtype=torch.float32, num_lanes=lanes, tiles_per_block=1)
    e_kahan = abs(float(ops.mma_sum_kahan(torch.from_numpy(x), **kw)) - exact)
    e_native = abs(float(ops.mma_sum_fused(torch.from_numpy(x), **kw)) - exact)
    e_ref_native = abs(float(RO.mma_sum_pallas(jnp.asarray(x), num_cores=lanes, tiles_per_block=1,
                                               compute_dtype="float32", interpret=True)) - exact)
    assert e_kahan <= e_native and e_kahan <= e_ref_native
    assert P.ulps(exact + e_native, exact) >= 10  # the comparison is not noise


def test_kahan_fold_is_the_reference_order():
    rng = np.random.default_rng(7)
    parts = torch.from_numpy((rng.standard_normal((5, 2, 128)) * 1e3).astype(np.float32))
    acc, comp = parts[:, 0], parts[:, 1]
    v = torch.stack([acc, -comp], dim=1).reshape(-1).numpy()
    want = float(RP.kahan_sum(jnp.asarray(v)))
    assert float(ops.combine_lane_partials_kahan(parts)) == want
    assert float(P.kahan_sum(torch.from_numpy(v))) == want


def _kahan_steps(values, s, c):
    """Serial Kahan steps in numpy float32 scalars (each operation rounds to
    f32): y = v - c; t = s + y; c = (t - s) - y; s = t."""
    for v in values:
        y = np.float32(v - c)
        t = np.float32(s + y)
        c = np.float32(np.float32(t - s) - y)
        s = t
    return s, c


@pytest.mark.parametrize("lanes", [1, 3, 528])
def test_lane_pairs_kahan_fold_is_the_stated_order(lanes):
    """K3's two-level fold, step by step: each lane's pass over its acc rows
    then its negated comp rows gives (s_c, c_c); one pass over s_0, -c_0,
    s_1, -c_1, ... gives the total. Partials span six decades, with random
    signs and compensations near an f32 ulp of their rows."""
    rng = np.random.default_rng(20 + lanes)
    acc = rng.choice([-1.0, 1.0], (lanes, 128)) * 10.0 ** rng.uniform(-3, 3, (lanes, 128))
    comp = acc * rng.uniform(-2.0**-24, 2.0**-24, (lanes, 128))
    parts = np.stack([acc, comp], axis=1).astype(np.float32)
    f0 = np.float32(0.0)
    pairs = []
    for lane in parts:
        s, c = _kahan_steps(np.concatenate([lane[0], -lane[1]]), f0, f0)
        pairs += [s, -c]
    want, _ = _kahan_steps(pairs, f0, f0)
    got = ops.combine_lane_pairs_kahan(torch.from_numpy(parts))
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == want.tobytes()


@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("cd", DTYPES, ids=[d[0] for d in DTYPES])
def test_kahan_plain_within_budget_of_the_oracle(lanes, cd):
    # 53 tiles in blocks of one: 53 lanes at most, zero tiles past them
    x = _x(53 * T - 77, seed=11)
    got = float(ops.mma_sum_kahan_plain(torch.from_numpy(x), cd[1], "identity", (), lanes, 1))
    assert abs(got - oracle(x, "sum")) <= budget_for(x, "sum", compute_dtype=cd[0])


def test_kahan_refuses_moments_and_census():
    x = torch.ones(10)
    with pytest.raises(ValueError):
        ops.mma_sum_kahan(x, prologue="moments")
    with pytest.raises(ValueError):
        ops.mma_sum_fused(x, kahan=True, census=True)


@pytest.mark.parametrize("block", [1, 1000, 4096, 2 * T + 3])
@pytest.mark.parametrize("prologue", ["identity", "square"])
def test_hier_blocks_equal_one_launch_per_block(block, prologue):
    x = _x(3 * T + 5, seed=8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tr = []
    got = ops.mma_sum_hier_blocks(xt, block, compute_dtype=torch.bfloat16, prologue=prologue,
                                  trace=tr)
    nblk = -(-x.size // block)
    flat = torch.nn.functional.pad(xt.float(), (0, nblk * block - x.size)).view(nblk, block)
    want = torch.stack([ops.mma_sum_hier(b, compute_dtype=torch.bfloat16, prologue=prologue)
                        for b in flat])
    assert torch.equal(got, want)
    model = cost_model.blocked_hier_hbm_bytes(x.size, 2, block)
    assert tr[0].hbm_bytes == model.total and tr[0].launch_io_bytes == model.launch_io
    assert tr[0].levels == (1 if block <= T else 2)


@pytest.mark.parametrize("m", [2, 4, 16, 128])
@pytest.mark.parametrize("n", [1, 17, 300, 65537])
def test_mma_sum_trace_and_classic_tree_match_reference(m, n):
    x = _x(n, seed=9)
    rtr, tr, rtc, tc = [], [], [], []
    want = float(RM.mma_sum(jnp.asarray(x), m=m, trace=rtr))
    got = float(M.mma_sum(torch.from_numpy(x), m=m, trace=tr))
    assert abs(got - want) <= budget_for(x, "sum", compute_dtype="bfloat16")
    r, g = rtr[0], tr[0]
    assert (g.levels, g.mma_ops, g.model_steps, g.predicted_steps) == (
        r.levels, r.mma_ops, r.model_steps, r.predicted_steps)
    want_c = float(RM.classic_tree_sum(jnp.asarray(x), trace=rtc))
    got_c = float(M.classic_tree_sum(torch.from_numpy(x), trace=tc))
    assert abs(got_c - want_c) <= 1e-6 * np.abs(x).sum()
    assert (tc[0].levels, tc[0].model_steps, tc[0].m) == (rtc[0].levels, rtc[0].model_steps, 2)
    assert float(M.mma_mean(torch.from_numpy(x), m=m)) == pytest.approx(got / n, rel=1e-6)


def test_empty_traces():
    tr, tc = [], []
    assert float(M.mma_sum(torch.zeros(0), trace=tr)) == 0.0
    assert float(M.classic_tree_sum(torch.zeros(0), trace=tc)) == 0.0
    assert tr[0].levels == tc[0].levels == 0
    assert float(ops.mma_sum_hier(torch.zeros(0))) == 0.0


@pytest.mark.parametrize("n", [10, 4096, 3 * 4096 + 1, 40000])
def test_precision_helpers_match_reference(n):
    x = _x(n, seed=10, scale=100.0)
    assert float(P.kahan_sum(torch.from_numpy(x))) == float(RP.kahan_sum(jnp.asarray(x)))
    want = float(RP.blocked_kahan_mma(jnp.asarray(x)))
    got = float(P.blocked_kahan_mma(torch.from_numpy(x)))
    assert abs(got - want) <= budget_for(x, "sum", compute_dtype="bfloat16")
    exact = x.astype(np.float64).sum()
    assert P.relative_error(got, exact) == abs(got - exact) / abs(exact)
    assert P.ulps(np.float32(exact), exact) <= 0.5
    assert P.ulps(exact + 3 * np.spacing(np.float32(abs(exact))), exact) == pytest.approx(3.0)
