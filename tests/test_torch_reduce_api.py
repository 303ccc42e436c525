"""Port parity of ``repro_torch.reduce.reduce`` for full reductions against
``repro.reduce.reduce``: every kind (sum, mean, sumsq, norm2, moments) on
the four backend pairs torch / xla, mma_torch / mma_jnp, cuda_hier /
pallas_hier and cuda_fused / pallas_fused (the kernels' plain versions on
the CPU against the Pallas kernels in interpret mode), at native and Kahan
precision; gradients of full moments; the plan arguments; and the reduce
demo on the CPU.

Tolerance: ``tests/harness.py``'s ``budget_for`` at the resolved plan's
compute dtype, each side against the f64 oracle and the two sides against
each other. Gradients are the same closed form (gs + 2 x gss): 1e-6
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import budget_for, oracle
from repro import reduce as RR
from repro_torch import reduce as R
from repro_torch.launch import reduce_demo
from repro_torch.reduce import plan as P

PAIRS = [("torch", "xla"), ("mma_torch", "mma_jnp"), ("cuda_hier", "pallas_hier"),
         ("cuda_fused", "pallas_fused")]
KINDS = ["sum", "mean", "sumsq", "norm2", "moments"]
N = 2 * 16384 + 5


def _operand(n=N, seed=0, dtype="float32"):
    x = (np.random.default_rng(seed).standard_normal(n) * 2 + 0.25).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return xj, xt


def _check(got, want, x, kind, compute_dtype):
    if kind == "moments":
        assert isinstance(got, tuple) and len(got) == 2
        s, ss = oracle(x, "moments")
        for g, w, o, k in zip(got, want, (s, ss), ("sum", "sumsq")):
            tol = budget_for(x, k, compute_dtype=compute_dtype)
            assert g.shape == () and g.dtype == torch.float32
            assert abs(float(g) - float(w)) <= tol and abs(float(g) - o) <= tol
        return
    tol = budget_for(x, kind, compute_dtype=compute_dtype)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= tol
    assert abs(float(got) - oracle(x, kind)) <= tol


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("precision", ["native", "kahan"])
def test_full_reduce_matches_reference(pair, kind, precision):
    backend, ref_backend = pair
    xj, xt = _operand()
    want = RR.reduce(xj, kind=kind, backend=ref_backend, precision=precision)
    got = R.reduce(xt, kind=kind, backend=backend, precision=precision)
    plan = R.plan_for(xt.shape, xt.dtype, kind=kind, backend=backend)
    _check(got, want, np.asarray(xj), kind, plan.compute_dtype)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_moments_over_all_axes_matches_reference(pair):
    # axes that cover every dimension are a full reduction: (sum, sumsq)
    backend, ref_backend = pair
    xj, xt = _operand(n=6 * 700, seed=1)
    cases = [(xj, xt, -1), (xj, xt, 0), (xj.reshape(6, 700), xt.view(6, 700), (0, 1)),
             (xj.reshape(6, 700), xt.view(6, 700), None)]
    for a, b, axis in cases:
        want = RR.reduce(a, axis=axis, kind="moments", backend=ref_backend)
        got = R.reduce(b, axis=axis, kind="moments", backend=backend)
        _check(got, want, np.asarray(a), "moments", "bfloat16")


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_full_moments_grad_matches_reference(pair):
    backend, ref_backend = pair
    xj, xt = _operand(n=16384 + 9, seed=2)

    def loss_ref(v):
        s, ss = RR.reduce(v, kind="moments", backend=ref_backend)
        return 0.7 * s + 0.3 * ss

    want = np.asarray(jax.grad(loss_ref)(xj))
    leaf = xt.clone().requires_grad_(True)
    s, ss = R.reduce(leaf, kind="moments", backend=backend)
    assert s.grad_fn is not None and ss.grad_fn is not None
    (got,) = torch.autograd.grad(0.7 * s + 0.3 * ss, leaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", ["sum", "norm2"])
def test_kahan_grad_matches_reference(pair, kind):
    backend, ref_backend = pair
    xj, xt = _operand(n=9000, seed=3)
    want = np.asarray(jax.grad(lambda v: RR.reduce(v, kind=kind, backend=ref_backend,
                                                   precision="kahan", kahan_block=1000))(xj))
    leaf = xt.clone().requires_grad_(True)
    out = R.reduce(leaf, kind=kind, backend=backend, precision="kahan", kahan_block=1000)
    (got,) = torch.autograd.grad(out, leaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kahan_block", [1000, 20000])
def test_plan_fields_reach_the_backend(pair, kahan_block):
    backend, ref_backend = pair
    xj, xt = _operand(dtype="bfloat16", seed=4)
    kw = dict(precision="kahan", kahan_block=kahan_block, tiles_per_block=2)
    want = RR.reduce(xj, backend=ref_backend, **kw)
    plan = R.plan_for(xt.shape, xt.dtype, backend=backend, **kw)
    assert (plan.precision, plan.kahan_block, plan.tiles_per_block) == ("kahan", kahan_block, 2)
    got = R.reduce(xt, plan=plan)
    _check(got, want, np.asarray(xj.astype(jnp.float32)), "sum", "bfloat16")
    # keyword fields override a given plan
    assert float(R.reduce(xt, plan=plan, precision="native")) == float(
        R.reduce(xt, backend=backend, tiles_per_block=2))


def test_kahan_rows_multiply_at_accumulator_width():
    xj, xt = _operand(n=40 * 300, seed=5)
    for backend, ref_backend in PAIRS:
        want = np.asarray(RR.reduce(xj.reshape(40, 300), axis=-1, backend=ref_backend,
                                    precision="kahan"))
        got = R.reduce(xt.view(40, 300), axis=-1, backend=backend, precision="kahan")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
        exact = np.asarray(xj, np.float64).reshape(40, 300).sum(-1)
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-4)


def test_backends_and_quarantine_chain():
    assert R.available_backends() == ("cuda_fused", "cuda_hier", "mma_torch", "segmented",
                                      "torch")
    R.quarantine_backend("cuda_hier")
    try:
        assert P._dequarantine("cuda_hier") == "mma_torch"
    finally:
        R.reinstate_backend("cuda_hier")
    with pytest.raises(ValueError):
        R.ReducePlan(precision="compensated")
    with pytest.raises(ValueError):  # the moments kernel has no Kahan carry
        R.get_backend("cuda_fused").moments_all(
            torch.ones(4), R.ReducePlan(backend="cuda_fused", precision="kahan"))
    # moments at precision="kahan": two compensated sums, on every backend
    for backend in ("torch", "mma_torch", "cuda_hier", "cuda_fused"):
        s, ss = R.reduce(torch.ones(5000), kind="moments", backend=backend, precision="kahan")
        assert float(s) == float(ss) == 5000.0


def test_census_with_kahan_counts_and_sums():
    x = _operand(seed=6)[1].clone()
    x[[3, 9000]] = torch.tensor([float("nan"), float("inf")])
    for backend in ("torch", "mma_torch", "cuda_hier", "cuda_fused"):
        s, c = R.reduce(x, backend=backend, precision="kahan", census=True)
        assert float(c) == 2.0 and not np.isfinite(float(s))


def test_reduce_demo_on_cpu(capsys):
    out = reduce_demo.main(["--device", "cpu", "--n", "65536", "--iters", "1"])
    text = capsys.readouterr().out
    assert "step counts" in text and "precision loss" in text and "time per call" in text
    for n, m, levels, steps, eq16, classic, s_meas, s17 in out["steps"]:
        assert levels == round(np.log(n) / np.log(m * m)) and steps == 5 * levels
        assert eq16 == pytest.approx(steps) and s_meas == pytest.approx(s17)
    assert [row[1] for row in out["steps"]] == [4, 4, 16, 16, 128]
    rel = {name: r for name, _, r in out["precision"]}
    assert len(rel) == 7 and all(np.isfinite(v) for v in rel.values())
    assert rel["mma f32 multipliers, f32 accum (cuda_hier)"] < 1e-5
    assert rel["mma bf16 multipliers, f32 accum (cuda_hier)"] < 2e-2
    assert [name for name, _ in out["times"]] == [name for name, _ in reduce_demo.TIMED]
    assert all(ms > 0 for _, ms in out["times"])
    # the segmented section: the reference demo's three segments, then the
    # numbers as 2048 packed segments (two empty in the middle)
    assert "segmented multi-reduce" in text
    for n, got, exact in out["segments"]["three"]:
        assert abs(got - exact) <= 2e-4 * exact
    assert out["segments"]["plan"].backend == "segmented"
    assert out["segments"]["count"] == 2048 and out["segments"]["worst_rel_to_mass"] < 8e-3
    offsets = out["segments"]["offsets"]
    assert offsets[0] == offsets[1] == 0 and offsets[-1] == 65536
    assert (np.diff(offsets) == 0).sum() >= 3


def test_reduce_demo_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        reduce_demo.main(["--n", "1024"])
