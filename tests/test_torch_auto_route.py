"""The port's auto route and the ``reduce`` / ``reduce_tree`` keywords
against the reference.

``plan_for`` on "auto" takes the operand's device and routes as the
reference's ``_auto_backend`` with the names mapped (xla -> torch, mma_jnp
-> mma_torch, pallas_fused / pallas_hier -> cuda_fused, "on a real TPU"
-> "on a CUDA device"); the CUDA cases pass ``device="cuda"`` as an
argument and need no card. ``reduce(accum_dtype=)`` and
``reduce_tree(plan=, num_lanes=)`` are held against the reference's
``reduce(accum_dtype=)`` and ``reduce_tree(plan=, num_cores=)`` on the
CPU (the kernels' plain versions against the Pallas kernels in interpret
mode).

Tolerance: ``tests/harness.py``'s ``budget_for`` at the plan's compute
dtype, plus two units in the last place of the accumulator dtype at the
result's magnitude (the two sides round slightly different f32 sums to
that dtype).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import budget_for, oracle
from repro import reduce as RR
from repro.reduce import plan as RP
from repro_torch import reduce as R
from repro_torch.reduce import api as A

NAMES = {"xla": "torch", "mma_jnp": "mma_torch", "pallas_fused": "cuda_fused",
         "pallas_hier": "cuda_fused"}
ROUTE_CASES = [  # shape, dtype, axis
    ((65536,), "int32", None),
    ((65536,), "bool", None),
    ((100,), "float32", None),
    ((129,), "float32", None),
    ((32767,), "float32", None),
    ((32768,), "float32", None),
    ((2**20,), "bfloat16", None),
    ((65536,), "float16", None),
    ((3, 40000), "float32", None),
    ((64, 4096), "float32", (1,)),
    ((64, 100), "float32", (1,)),
    ((4, 256, 256), "float32", (1, 2)),
    ((4096,), "float64", None),
    ((32768,), "float64", None),
    ((64, 4096), "float64", (1,)),
]


def _ref_auto(shape, dtype, axis, on_card, monkeypatch):
    if on_card:  # the reference's "on a real TPU" branch
        monkeypatch.setattr(RP.jax, "default_backend", lambda: "tpu")
    try:
        return RP._auto_backend(shape, jnp.dtype(dtype), kind="sum", axis=axis, m=128)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("shape,dtype,axis", ROUTE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in ROUTE_CASES])
def test_auto_route_matches_reference(shape, dtype, axis, device, monkeypatch):
    want = NAMES[_ref_auto(shape, dtype, axis, device == "cuda", monkeypatch)]
    if want == "cuda_fused" and dtype == "float64":
        want = "mma_torch"  # the kernels read f32, bf16 and f16 only (no f64 on a TPU either)
    got = R.plan_for(shape, getattr(torch, dtype), axis=axis, device=device).backend
    assert got == want


def test_auto_route_full_reductions_on_the_card():
    # non-float data -> torch; >= 2 x 128^2 elements on a CUDA device -> the
    # fused kernel; the same problem off the card -> mma_torch
    assert R.plan_for((65536,), torch.int32, device="cuda").backend == "torch"
    assert R.plan_for((2 * 128 * 128,), torch.float32, device="cuda").backend == "cuda_fused"
    assert R.plan_for((2 * 128 * 128,), torch.float32,
                      device=torch.device("cuda", 0)).backend == "cuda_fused"
    assert R.plan_for((2 * 128 * 128,), torch.float32, device="cpu").backend == "mma_torch"
    assert R.plan_for((2 * 128 * 128,), torch.float32).backend == "mma_torch"
    assert R.plan_for((2 * 128 * 128 - 1,), torch.float32, device="cuda").backend == "mma_torch"
    # the quarantine rotation applies to the auto choice, not to a pin
    R.quarantine_backend("cuda_fused")
    try:
        assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "mma_torch"
        assert R.plan_for((2**20,), torch.float32, device="cuda",
                          backend="cuda_fused").backend == "cuda_fused"
    finally:
        R.reinstate_backend("cuda_fused")


def test_auto_route_keeps_off_the_kernels_what_they_cannot_read():
    n = (2 * 128 * 128,)
    route = lambda dtype=torch.float32, **kw: R.plan_for(n, dtype, device="cuda", **kw).backend
    assert route(torch.float64) == "mma_torch"
    assert route(compute_dtype="float64") == "mma_torch"
    assert route(precision="kahan", accum_dtype="float64") == "mma_torch"  # the census's width
    assert route(accum_dtype="float64") == "cuda_fused"
    assert route(precision="kahan") == "cuda_fused"
    assert route(kind="moments", precision="kahan") == "cuda_fused"
    assert route(torch.float16, compute_dtype="float16") == "cuda_fused"
    # the segmented executor applies the same rule to its plan
    for dtype, want in ((torch.float64, "mma_torch"), (torch.float32, "cuda_fused")):
        plan = R.plan_for((2**20,), dtype, segments=2, device="cuda")
        assert R.segmented_backend_for(2**20, dtype, 128, "cuda", plan) == want
    assert R.segmented_backend_for(2**20, torch.float64, 128, "cuda") == "cuda_fused"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
@pytest.mark.parametrize("kind", ["sum", "mean", "sumsq", "norm2", "moments"])
def test_every_card_auto_plan_runs(dtype, kind):
    # the plan auto picks for a card operand, replayed on a CPU tensor (the
    # wrappers check their arguments before they take the plain version):
    # no kind x precision x accumulator x census the planner sends to a
    # kernel backend may raise there
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(2 * 128 * 128))
    x = x.to(getattr(torch, dtype))
    for precision in ("native", "kahan"):
        for accum in (None, "float64"):
            plan = R.plan_for(x.shape, x.dtype, kind=kind, precision=precision,
                              accum_dtype=accum, device="cuda")
            for census in (False, True) if kind != "moments" else (False,):
                got = R.reduce(x, kind=kind, plan=plan, census=census)
                first = got[0] if isinstance(got, tuple) else got
                assert bool(torch.isfinite(first)), (plan, census)


def test_reduce_and_reduce_tree_route_by_the_operands_device(monkeypatch):
    seen = []
    real = A.plan_for

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(A, "plan_for", spy)
    x = torch.ones(40000)
    R.reduce(x)
    R.reduce_tree([x, x[:3]], kind="sumsq")
    R.reduce_many([x, x[:3]])
    assert seen == [x.device] * 3


PAIRS = [("torch", "xla"), ("mma_torch", "mma_jnp"), ("cuda_hier", "pallas_hier"),
         ("cuda_fused", "pallas_fused")]
ACCUMS = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _operand(n=2 * 16384 + 5, seed=3):
    x = (np.random.default_rng(seed).standard_normal(n) * 2 + 0.25).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _ulp(v: float, dtype: str) -> float:
    return float(np.spacing(np.abs(np.asarray(v, np.float32)).astype(jnp.dtype(dtype))))


# (the sum of squares overflows f16 on both sides: f16 takes the sums only)
KIND_ACCUMS = [(k, a) for k in ("sum", "mean", "sumsq", "norm2", "moments")
               for a in ("float32", "bfloat16", "float16")
               if a != "float16" or k in ("sum", "mean")]


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind,accum", KIND_ACCUMS)
def test_reduce_accum_dtype_matches_reference(pair, kind, accum):
    backend, ref_backend = pair
    xj, xt = _operand()
    want = RR.reduce(xj, kind=kind, backend=ref_backend, accum_dtype=accum)
    got = R.reduce(xt, kind=kind, backend=backend, accum_dtype=accum)
    plan = R.plan_for(xt.shape, xt.dtype, kind=kind, backend=backend, accum_dtype=accum)
    assert plan.accum_dtype == accum
    pairs = zip(got, want, ("sum", "sumsq")) if kind == "moments" else ((got, want, kind),)
    x = np.asarray(xj)
    for g, w, k in pairs:
        assert g.dtype == ACCUMS[accum] and str(w.dtype) == accum
        tol = budget_for(x, k, compute_dtype=plan.compute_dtype) + 2 * _ulp(float(w), accum)
        assert abs(float(g) - float(w)) <= tol
        assert abs(float(g) - oracle(x, k)) <= tol


def _leaves(seed=5):
    rng = np.random.default_rng(seed)
    shapes = [(130, 257), (4096,), (3,), (64, 64), ()]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", ["sum", "sumsq", "norm2"])
@pytest.mark.parametrize("lanes", [None, 2])
def test_reduce_tree_plan_and_lanes_match_reference(pair, kind, lanes):
    backend, ref_backend = pair
    lj, lt = _leaves()
    total = sum(int(np.prod(a.shape)) for a in lj)
    pkind = "sum" if kind == "sum" else "sumsq"
    ref_plan = RR.plan_for((total,), jnp.float32, kind=pkind, backend=ref_backend,
                           compute_dtype="float32")
    plan = R.plan_for((total,), torch.float32, kind=pkind, backend=backend,
                      compute_dtype="float32")
    want = RR.reduce_tree(lj, kind=kind, plan=ref_plan, num_cores=lanes)
    got = R.reduce_tree(lt, kind=kind, plan=plan, num_lanes=lanes)
    flat = np.concatenate([np.asarray(a).reshape(-1) for a in lj])
    tol = budget_for(flat, kind, compute_dtype="float32")
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= tol
    assert abs(float(got) - oracle(flat, kind)) <= tol
    # with an epilogue fork and the per-leaf sums, as the optimizer asks
    fork = [(), ("clip_coeff", 1.0, 1e-6)]
    wp, wf = RR.reduce_tree(lj, kind=kind, plan=ref_plan, num_cores=lanes, epilogue=fork,
                            return_per_leaf=True)
    gp, gf = R.reduce_tree(lt, kind=kind, plan=plan, num_lanes=lanes, epilogue=fork,
                           return_per_leaf=True)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-5, atol=1e-6)


def test_reduce_tree_keywords_override_the_plan(monkeypatch):
    used = []
    real = A._backends.get_backend

    def spy(name):
        used.append(name)
        return real(name)

    monkeypatch.setattr(A._backends, "get_backend", spy)
    _, lt = _leaves()
    plan = R.plan_for((10,), torch.float32, kind="sumsq", backend="torch", num_lanes=4)
    R.reduce_tree(lt, plan=plan)
    assert used[-1] == "torch"
    R.reduce_tree(lt, plan=plan, backend="mma_torch", num_lanes=2)
    assert used[-1] == "mma_torch"
    seen = []
    real_replace = R.ReducePlan.replace
    monkeypatch.setattr(R.ReducePlan, "replace",
                        lambda self, **kw: seen.append(kw) or real_replace(self, **kw))
    R.reduce_tree(lt, plan=plan, num_lanes=2)
    assert seen == [{"num_lanes": 2}]
