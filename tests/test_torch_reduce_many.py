"""Port parity for ``repro_torch.reduce.reduce_many`` and the parts kernel
K4 completed: every backend x kind x dtype against
``repro.reduce.reduce_many`` (the Pallas kernels in interpret mode) for
``axis=None`` and ``axis=-1``; the empty list, zero-size arrays, epilogues
and gradients (against ``jax.grad``); more than 128 arrays, which pack and
take one ``sum_segments`` pass; ``mma_sum_parts`` (its plain version) at
bf16 and f16 compute, with moments parts and a slot epilogue, against
``mma_sum_parts_pallas``; the ``reduce_tree`` gradient on the kernel
backends; and the multi-reduce plans.

Tolerance: ``tests/harness.py``'s ``budget_for`` of each array at the
resolved plan's compute dtype (sums of squares and moments by their own
mass), against the reference's value; gradients are closed forms of the
same values (1e-5 relative, bf16 rounding of x in the moments square
aside). Arrays hold at most a few 16384-element tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import COMPUTE_REL, budget_for
from repro import reduce as RR
from repro.kernels.mma_reduce import ops as RO
from repro_torch import reduce as R
from repro_torch.kernels.mma_reduce import ops

T = 16384
PAIRS = [("torch", "xla"), ("mma_torch", "mma_jnp"), ("cuda_hier", "pallas_hier"),
         ("cuda_fused", "pallas_fused"), ("segmented", "segmented")]
KINDS = ["sum", "mean", "sumsq", "norm2", "moments"]
SIZES = (100, 0, 20000, 2 * T + 5)


def _arrays(dtype, sizes=SIZES, seed=0):
    rng = np.random.default_rng(seed)
    xs = [jnp.asarray((rng.standard_normal(n) * 2 + 0.3).astype(np.float32)).astype(dtype)
          for n in sizes]
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)) for x in xs]
    return xs, ts


def _budget(x, kind, cd):
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 1e-6
    return budget_for(x, kind, compute_dtype=cd) + 1e-6


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_reduce_many_full_matches_reference(pair, kind, dtype):
    backend, ref_backend = pair
    xs, ts = _arrays(dtype, seed=len(kind))
    want = RR.reduce_many(xs, kind=kind, backend=ref_backend)
    got = R.reduce_many(ts, kind=kind, backend=backend)
    plan = R.plan_for((sum(t.numel() for t in ts),), ts[0].dtype, kind=kind, backend=backend,
                      segments=len(ts))
    cd = plan.compute_dtype
    if kind == "moments":
        for g, w, k in zip(got, want, ("sum", "sumsq")):
            assert g.shape == (len(ts),) and g.dtype == torch.float32
            for s, x in enumerate(xs):
                assert abs(float(g[s]) - float(w[s])) <= _budget(x, k, cd), (k, s)
        return
    assert got.shape == (len(ts),) and got.dtype == torch.float32
    for s, x in enumerate(xs):
        assert abs(float(got[s]) - float(want[s])) <= _budget(x, kind, cd), s


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
def test_reduce_many_rows_match_reference(pair, kind):
    backend, ref_backend = pair
    rng = np.random.default_rng(3)
    shapes = [(3, 300), (2, 0), (4, 1000), (0, 7), (50,)]
    xs = [(rng.standard_normal(s) * 2).astype(np.float32) for s in shapes]
    want = RR.reduce_many([jnp.asarray(x) for x in xs], kind=kind, axis=-1, backend=ref_backend)
    got = R.reduce_many([torch.from_numpy(x) for x in xs], kind=kind, axis=-1, backend=backend)
    pairs = zip(got, want) if kind != "moments" else zip(got[0] + got[1], want[0] + want[1])
    for g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2)


def test_reduce_many_empty_list_zero_size_and_epilogue():
    for axis in (None, -1):
        for kind in KINDS:
            got = R.reduce_many([], kind=kind, axis=axis)
            want = RR.reduce_many([], kind=kind, axis=axis)
            if axis is None:
                flat = got if kind != "moments" else got[0]
                assert flat.shape == (0,)
            else:
                assert got == (([], []) if kind == "moments" else []) == \
                    (list(want) if kind != "moments" else ([], []))
    # zero-size arrays reduce to the identity (an empty mean to 0 / 1)
    xs, ts = _arrays("float32", sizes=(0, 300, 0))
    for backend in ("torch", "cuda_fused", "segmented"):
        np.testing.assert_array_equal(R.reduce_many(ts, kind="mean", backend=backend)[[0, 2]],
                                      [0.0, 0.0])
    # a chain maps every per-array statistic, as the reference's
    chain = (("add_eps", 1.0), ("sqrt",))
    xs, ts = _arrays("float32")
    for backend, ref_backend in PAIRS:
        for kind in ("sum", "sumsq", "norm2"):
            want = np.asarray(RR.reduce_many([abs(x) for x in xs], kind=kind,
                                             backend=ref_backend, epilogue=chain))
            got = R.reduce_many([t.abs() for t in ts], kind=kind, backend=backend,
                                epilogue=chain).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-2)
    with pytest.raises(ValueError):
        R.reduce_many(ts, kind="mean", epilogue=chain)
    with pytest.raises(ValueError):
        R.reduce_many(ts, axis=0)
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        R.reduce_many(ts, mesh_axes="data")


@pytest.mark.parametrize("backend,ref_backend", [("cuda_fused", "pallas_fused"),
                                                 ("cuda_hier", "pallas_hier"),
                                                 ("mma_torch", "mma_jnp"),
                                                 ("segmented", "segmented")])
@pytest.mark.parametrize("kind", KINDS)
def test_reduce_many_gradients_match_jax_grad(backend, ref_backend, kind):
    rng = np.random.default_rng(4)
    xs = [(rng.standard_normal(n) * 2 + 0.3).astype(np.float32) for n in (300, 0, 20000)]
    ws = [rng.standard_normal(2 if kind == "moments" else 1).astype(np.float32) for _ in xs]
    w = np.stack(ws, -1)  # (1 or 2, N)

    def loss(arrs):
        out = RR.reduce_many(arrs, kind=kind, backend=ref_backend)
        out = jnp.stack(out) if kind == "moments" else out[None]
        return jnp.sum(jnp.asarray(w) * out)

    want = jax.grad(loss)([jnp.asarray(x) for x in xs])
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = R.reduce_many(ts, kind=kind, backend=backend)
    out = torch.stack(out) if kind == "moments" else out[None]
    got = torch.autograd.grad((torch.from_numpy(w) * out).sum(), ts, allow_unused=True)
    for g, wg in zip(got, want):
        g = np.zeros(wg.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,ref_backend", [("cuda_fused", "pallas_fused"),
                                                 ("cuda_hier", "pallas_hier")])
@pytest.mark.parametrize("kind", ["sum", "sumsq", "moments"])
def test_more_than_128_arrays_pack_and_take_one_segments_pass(monkeypatch, backend,
                                                              ref_backend, kind):
    rng = np.random.default_rng(5)
    sizes = [int(s) for s in rng.integers(1, 400, size=131)]
    sizes[7] = 0
    xs = [(rng.standard_normal(n) * 2 + 0.3).astype(np.float32) for n in sizes]
    calls = []
    real = ops.mma_sum_segments

    def recording(flat, offsets, **kw):
        calls.append((flat.numel(), len(offsets) - 1, kw.get("prologue", "identity")))
        return real(flat, offsets, **kw)

    monkeypatch.setattr(ops, "mma_sum_segments", recording)
    parts_calls = []
    real_parts = ops.mma_sum_parts
    monkeypatch.setattr(ops, "mma_sum_parts",
                        lambda *a, **kw: parts_calls.append(1) or real_parts(*a, **kw))
    want = RR.reduce_many([jnp.asarray(x) for x in xs], kind=kind, backend=ref_backend)
    got = R.reduce_many([torch.from_numpy(x) for x in xs], kind=kind, backend=backend)
    assert parts_calls == []
    nseg = 2 * len(xs) if kind == "moments" else len(xs)
    packed = 2 * sum(sizes) if kind == "moments" else sum(sizes)
    assert calls == [(packed, nseg, "identity")]
    cd = "bfloat16" if kind != "sumsq" else "float32"
    got = torch.cat(got) if kind == "moments" else got
    want = np.concatenate(want) if kind == "moments" else np.asarray(want)
    for s, x in enumerate(xs + (xs if kind == "moments" else [])):
        k = "sumsq" if (kind == "sumsq" or (kind == "moments" and s >= len(xs))) else "sum"
        assert abs(float(got[s]) - float(want[s])) <= _budget(x, k, cd), s


PARTS_CASES = [  # prologues, slot epilogue
    ("identity", ()),
    ("square", ()),
    (("identity", "abs", "square", "identity"), ()),
    (("moments", "identity", "moments", "square"), ()),
    ("abs", (("add_eps", 1.5), ("sqrt",))),
]


@pytest.mark.parametrize("case", PARTS_CASES, ids=lambda c: str(c[0]) + ("-chain" if c[1]
                                                                        else ""))
@pytest.mark.parametrize("cd", ["bfloat16", "float16", "float32"])
def test_parts_kernel_plain_matches_pallas(case, cd):
    pros, chain = case
    rng = np.random.default_rng(6)
    xs = [(rng.standard_normal(n) * 2 + 0.3).astype(np.float32) for n in (700, 0, T + 5,
                                                                           2 * T)]
    want = np.asarray(RO.mma_sum_parts_pallas([jnp.asarray(x) for x in xs], compute_dtype=cd,
                                              prologue=pros, slot_epilogue=chain,
                                              interpret=True))
    got = ops.mma_sum_parts([torch.from_numpy(x) for x in xs], compute_dtype=getattr(torch, cd),
                            prologue=pros, slot_epilogue=chain).numpy()
    assert got.shape == want.shape
    names = (pros,) * len(xs) if isinstance(pros, str) else pros
    nseg = len(xs)
    for s, (x, pro) in enumerate(zip(xs, names)):
        sq = pro in ("square", "moments") and pro != "moments"
        tol = COMPUTE_REL[cd] * max(float(np.sum(x.astype(np.float64) ** 2 if sq
                                                 else np.abs(x))), 1.0)
        if chain:
            tol = tol / (2 * np.sqrt(float(np.abs(x).sum()) + 1.5))
        assert abs(got[s] - want[s]) <= tol + 1e-6, (s, got[s], want[s])
        if got.size == 2 * nseg:
            tol2 = COMPUTE_REL[cd] * max(float(np.sum(x.astype(np.float64) ** 2)), 1.0)
            assert abs(got[nseg + s] - want[nseg + s]) <= tol2 + 1e-6
    # the empty part keeps 0, also under a slot chain (the reference's)
    assert got[1] == want[1] == 0.0


def test_parts_kernel_census_and_chains_at_bf16_compute():
    rng = np.random.default_rng(7)
    xs = [(rng.standard_normal(n) * 2).astype(np.float32) for n in (500, T + 3)]
    xs[1][9] = np.nan
    xs[0][3] = 3.4e38  # finite in f32, inf once rounded to bf16: counted
    chains = ((), (("clip_coeff", 1.0),))
    want = np.asarray(RO.mma_sum_parts_pallas([jnp.asarray(x) for x in xs],
                                              compute_dtype="bfloat16", prologue="square",
                                              total_chains=chains, census=True,
                                              interpret=True))
    got = ops.mma_sum_parts([torch.from_numpy(x) for x in xs], compute_dtype=torch.bfloat16,
                            prologue="square", total_chains=chains, census=True).numpy()
    np.testing.assert_array_equal(got[4:], want[4:])  # the counts
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    with pytest.raises(ValueError):
        ops.mma_sum_parts([torch.ones(3)], prologue="moments", census=True)


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda_hier"])
@pytest.mark.parametrize("kind", ["sumsq", "norm2", "sum"])
@pytest.mark.parametrize("fork", [None, [(), ("clip_coeff", 1.0)]])
def test_reduce_tree_gradient_on_kernel_backends_matches_jax_grad(backend, kind, fork):
    """The fault this slice repairs: a kernel backend's reduce_tree on
    leaves that require grad raised instead of differentiating."""
    rng = np.random.default_rng(8)
    xs = [(rng.standard_normal(n) * 0.02).astype(np.float32) for n in (300, 0, 20000, 7)]

    def loss(leaves):
        out = RR.reduce_tree(leaves, kind, backend="pallas_fused", epilogue=fork)
        return jnp.sum(out * jnp.arange(1, out.size + 1, dtype=jnp.float32))

    want = jax.grad(loss)([jnp.asarray(x) for x in xs])
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = R.reduce_tree(ts, kind, backend=backend, epilogue=fork)
    out = out.reshape(-1)
    got = torch.autograd.grad((out * torch.arange(1, out.numel() + 1)).sum(), ts,
                              allow_unused=True)
    for g, wg in zip(got, want):
        g = np.zeros(wg.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wg), rtol=1e-5, atol=1e-6)


def test_multi_reduce_plans_route_as_the_reference():
    for shape, kind in (((40000,), "sum"), ((40000,), "sumsq"), ((100,), "moments")):
        want = RR.plan_for(shape, jnp.float32, kind=kind, segments=3)
        got = R.plan_for(shape, torch.float32, kind=kind, segments=3)
        assert got.backend == want.backend == "segmented"
        assert got.compute_dtype == want.compute_dtype
        assert R.plan_for(shape, torch.float32, kind=kind).backend != "segmented"
    assert R.plan_for((40000,), torch.float32, segments=3, backend="torch").backend == "torch"
    for n, dtype, device, want in (
            (40000, torch.int32, "cuda", "torch"), (100, torch.float32, "cuda", "torch"),
            (2 * T, torch.float32, "cuda", "cuda_fused"),
            (2 * T - 1, torch.float32, "cuda", "mma_torch"),
            (2 * T * 128, torch.float32, "cpu", "mma_torch"),
            (2 * T * 128, torch.bfloat16, None, "mma_torch")):
        assert R.segmented_backend_for(n, dtype, 128, device) == want, (n, dtype, device)
    assert R.segmented_backend_for(40000, torch.float32, 16, "cuda") == "mma_torch"
    assert RR.segmented_backend_for(40000, jnp.int32, 128) == "xla"
    R.quarantine_backend("cuda_fused")
    try:
        assert R.segmented_backend_for(2 * T * 128, torch.float32, 128, "cuda") == "mma_torch"
    finally:
        R.reinstate_backend("cuda_fused")
