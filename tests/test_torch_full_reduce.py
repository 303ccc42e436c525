"""Port parity: full reductions ``repro_torch.reduce.reduce(x)`` (axis=None)
against ``repro.reduce.reduce`` on the same seeded operand, for the three
backend pairs torch / xla, mma_torch / mma_jnp and cuda_fused (the fused
kernel K1's plain version on the CPU) / pallas_fused (interpret mode);
kinds sum, mean, sumsq, norm2, each plain, with an epilogue chain and with
the census; lane counts against the f64 oracle; gradients against
``jax.grad``.

Tolerance: ``tests/harness.py``'s ``budget_for`` -- the error a reduction
may make, per unit of the mass it accumulates, at the multiplier width of
the resolved plan (bf16 for sum/mean, f32 for sumsq/norm2). Each side is
held to it against the f64 oracle, and the two sides to it against each
other. Census counts are exact integers and must be equal. Gradients are
the same closed forms (broadcast, 2 x g, the chain's derivative at the
total): 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import budget_for, oracle
from repro import reduce as RR
from repro_torch import reduce as R
from repro_torch.kernels import mma_reduce
from repro_torch.models.convert import tensor_from_numpy

N = 3 * 16384 + 5  # four m^2 tiles, the last ragged
PAIRS = [("torch", "xla"), ("mma_torch", "mma_jnp"), ("cuda_fused", "pallas_fused")]
KINDS = ["sum", "mean", "sumsq", "norm2"]
CHAIN = (("scale", 0.5), ("add_eps", 3.0))


def _operand(dtype="float32", seed=0, n=N):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 2 + 0.25
    xj = jnp.asarray(x).astype(dtype)
    return xj, tensor_from_numpy(np.asarray(xj))


def _finish(v, chained):
    return v * 0.5 + 3.0 if chained else v


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chained", [False, True], ids=["plain", "epilogue"])
def test_full_reduce_matches_reference(pair, kind, chained):
    backend, ref_backend = pair
    xj, xt = _operand()
    epi = CHAIN if chained else None
    want = float(RR.reduce(xj, kind=kind, backend=ref_backend, epilogue=epi))
    got = R.reduce(xt, kind=kind, backend=backend, epilogue=epi)
    assert got.shape == () and got.dtype == torch.float32
    plan = R.plan_for(xt.shape, xt.dtype, kind=kind, backend=backend)
    tol = budget_for(np.asarray(xj), kind, compute_dtype=plan.compute_dtype)
    tol = tol * 0.5 if chained else tol
    assert abs(float(got) - want) <= tol
    assert abs(float(got) - _finish(oracle(np.asarray(xj), kind), chained)) <= tol


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-inf"])
def test_census_matches_reference(pair, kind, poison):
    backend, ref_backend = pair
    xj, xt = _operand(seed=1)
    if poison:
        x = np.asarray(xj).copy()
        x[[7, 16384, N - 1]] = [np.nan, np.inf, -np.inf]
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want_s, want_c = RR.reduce(xj, kind=kind, backend=ref_backend, epilogue=CHAIN, census=True)
    got_s, got_c = R.reduce(xt, kind=kind, backend=backend, epilogue=CHAIN, census=True)
    assert float(got_c) == float(want_c) == (3.0 if poison else 0.0)
    if poison:
        assert not np.isfinite(float(got_s)) and not np.isfinite(float(want_s))
    else:
        plan = R.plan_for(xt.shape, xt.dtype, kind=kind, backend=backend)
        tol = 0.5 * budget_for(np.asarray(xj), kind, compute_dtype=plan.compute_dtype)
        assert abs(float(got_s) - float(want_s)) <= tol


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lanes_against_oracle(lanes, kind, dtype):
    # 3 blocks of 8 tiles and a ragged fourth, so 2 and 3 lanes really stripe
    xj, xt = _operand(dtype, seed=2, n=3 * 8 * 16384 + 77)
    got = R.reduce(xt, kind=kind, backend="cuda_fused", num_lanes=lanes)
    plan = R.plan_for(xt.shape, xt.dtype, kind=kind, backend="cuda_fused")
    assert abs(float(got) - oracle(np.asarray(xj), kind)) <= budget_for(
        np.asarray(xj), kind, compute_dtype=plan.compute_dtype)


def test_lane_fold_is_fixed():
    # the plain version folds the lanes exactly as combine_lane_partials
    # says, and the fold itself is the kernel's fixed tree
    _, xt = _operand(seed=3, n=6 * 8 * 16384 + 9)
    r, c, bpl, tpad = mma_reduce.lane_geometry(xt.numel(), 5)
    assert (r, c, bpl, tpad) == (8, 5, 2, 80)
    flat = torch.nn.functional.pad(xt.to(torch.bfloat16).float(), (0, tpad * 16384 - xt.numel()))
    lanes = flat.view(bpl, c, 8 * 16384).sum(dim=(0, 2))
    want = mma_reduce.combine_lane_partials(lanes)
    got = mma_reduce.mma_sum_fused(xt, num_lanes=5)
    assert torch.equal(got, want)
    parts = torch.arange(1000, dtype=torch.float32) * 0.37
    seq = torch.zeros(256)
    for j in range(4):
        seq = seq + torch.nn.functional.pad(parts, (0, 24))[j * 256:(j + 1) * 256]
    w = seq.view(8, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[:, :off] + w[:, off:2 * off]
    tot = torch.zeros(())
    for i in range(8):
        tot = tot + w[i, 0]
    assert torch.equal(mma_reduce.combine_lane_partials(parts), tot)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chained", [False, True], ids=["plain", "epilogue"])
def test_full_reduce_grad_matches_reference(pair, kind, chained):
    backend, ref_backend = pair
    xj, xt = _operand(seed=4, n=2 * 16384 + 3)
    epi = CHAIN if chained else None
    want = np.asarray(jax.grad(lambda v: RR.reduce(v, kind=kind, backend=ref_backend,
                                                   epilogue=epi))(xj))
    leaf = xt.clone().requires_grad_(True)
    out = R.reduce(leaf, kind=kind, backend=backend, epilogue=epi)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, leaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


def test_census_refuses_grad():
    leaf = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError):
        R.reduce(leaf, census=True, backend="cuda_fused")


def test_empty_and_no_axes():
    for backend in ("torch", "mma_torch", "cuda_fused"):
        z = torch.zeros(0)
        assert float(R.reduce(z, backend=backend)) == 0.0
        assert np.isnan(float(R.reduce(z, kind="mean", backend=backend)))
        s, c = R.reduce(z, kind="norm2", backend=backend, census=True)
        assert float(s) == 0.0 and float(c) == 0.0
    x = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    assert torch.equal(R.reduce(x, axis=(), kind="norm2"), x.abs())
    assert torch.equal(R.reduce(x, axis=(0, 1)), R.reduce(x))
