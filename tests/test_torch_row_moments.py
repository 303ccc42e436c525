"""Port parity: ``repro_torch.kernels.row_moments`` (layernorm_np, rmsnorm)
against the reference's Pallas kernels (interpret mode on the CPU).

Inputs come from numpy with a seed and reach both sides bit-identically
(bf16 through ``tensor_from_numpy``). Row counts are ragged (not a
multiple of the reference's 256-row block). On the CPU the port runs the
kernels' plain versions.

Tolerances: both sides round x and x*x to bf16 before the all-ones row
sums and accumulate in f32, in different orders. f32 outputs therefore
agree to a few f32 ulps (atol 1e-5 at |y| <= ~10); bf16 outputs may differ
by at most one bf16 ulp where an f32 result sits near a rounding boundary
(|a - b| <= 2^-7 * |a|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layernorm_np as ref_layernorm_np
from repro.kernels import rmsnorm as ref_rmsnorm
from repro_torch.kernels import common, layernorm_np, rmsnorm
from repro_torch.models.convert import tensor_from_numpy

SHAPES = [(300, 64), (37, 128), (3, 5, 48), (1, 16)]


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    g = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, jnp.asarray(g), tensor_from_numpy(np.asarray(xj)), torch.from_numpy(g)


def _close(got: torch.Tensor, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_np_matches_reference(shape, dtype):
    xj, _, xt, _ = _inputs(shape, dtype)
    out = layernorm_np(xt, 1e-5)
    assert out.dtype == xt.dtype
    _close(out, ref_layernorm_np(xj, 1e-5), dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(shape, dtype):
    xj, gj, xt, gt = _inputs(shape, dtype, seed=1)
    out = rmsnorm(xt, gt, 1e-6)
    assert out.dtype == xt.dtype
    _close(out, ref_rmsnorm(xj, gj, 1e-6), dtype)


def test_cpu_path_counts_no_launch():
    _, _, xt, gt = _inputs((4, 32), "float32")
    before = common.launch_counts()
    layernorm_np(xt)
    rmsnorm(xt, gt)
    assert common.launch_counts() == before
