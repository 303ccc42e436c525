"""Port parity: ``repro_torch.kernels.row_moments`` (layernorm_np, rmsnorm)
against the reference's Pallas kernels (interpret mode on the CPU).

Inputs come from numpy with a seed and reach both sides bit-identically
(bf16 through ``tensor_from_numpy``). Row counts are ragged (not a
multiple of the reference's 256-row block). On the CPU the port runs the
kernels' plain versions.

Tolerances: both sides round x and x*x to bf16 before the all-ones row
sums and accumulate in f32, in different orders. f32 outputs therefore
agree to a few f32 ulps (atol 1e-5 at |y| <= ~10); bf16 and f16 outputs
may differ by at most one ulp of their type where an f32 result sits near
a rounding boundary, held to the bf16 bound (|a - b| <= 2^-7 * |a|).

The CUDA kernel's launch plan (``launch_plan``: route, warps a row, rows a
CTA, chunks a lane, slabs) is checked here too: every column of a row is
held by exactly one lane under the kernel's chunk map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layernorm_np as ref_layernorm_np
from repro.kernels import rmsnorm as ref_rmsnorm
from repro_torch.kernels import common, layernorm_np, rmsnorm
from repro_torch.kernels.row_moments import ROUTE_ELEMENT, ROUTE_VECTOR, launch_plan
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


@pytest.mark.parametrize("shape", [(37, 100), (3, 50), (2, 5, 100), (300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_norms_any_d_and_f16_match_reference(shape, dtype):
    # d not a multiple of 16 (100, 50), and f16 input
    xj, gj, xt, gt = _inputs(shape, dtype, seed=2)
    for got, want in ((layernorm_np(xt, 1e-5), ref_layernorm_np(xj, 1e-5)),
                      (rmsnorm(xt, gt, 1e-6), ref_rmsnorm(xj, gj, 1e-6))):
        assert got.dtype == xt.dtype
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_norms_of_an_offset_view_match_reference(dtype):
    # a contiguous view one element past its buffer's start
    xj, gj, xt, gt = _inputs((37, 128), dtype, seed=3)
    buf = torch.zeros(xt.numel() + 1, dtype=xt.dtype)
    buf[1:] = xt.reshape(-1)
    view = buf[1:].view(xt.shape)
    assert view.is_contiguous() and view.data_ptr() != buf.data_ptr()
    _close(layernorm_np(view, 1e-5), ref_layernorm_np(xj, 1e-5), dtype)
    _close(rmsnorm(view, gt, 1e-6), ref_rmsnorm(xj, gj, 1e-6), dtype)


PLAN_CASES = [(rows, d, dtype, aligned)
              for rows in (1, 4, 37, 1024, 2049)
              for d in (1, 16, 50, 100, 2048, 2050, 6144, 40000, 40001)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)
              for aligned in (True, False)]


@pytest.mark.parametrize("rows,d,dtype,aligned", PLAN_CASES[::3] + PLAN_CASES[1::7])
def test_launch_plan_covers_every_column_once(rows, d, dtype, aligned):
    p = launch_plan(rows, d, dtype, aligned)
    per_chunk = 16 // dtype.itemsize
    nchunks = -(-d // per_chunk)
    vector = aligned and d * dtype.itemsize % 16 == 0
    assert p.route == (ROUTE_VECTOR if vector else ROUTE_ELEMENT)
    assert 1 <= p.chunks <= 8 and 1 <= p.warps_per_row <= 16
    assert p.rows_per_cta * p.warps_per_row <= 16  # 512 threads a CTA
    assert p.rows_per_cta <= rows
    assert (p.slabs > 1) == (nchunks > 16 * 32 * 8)
    # the kernel's maps: chunk c = s * chunks + i of lane l = 32 w + t of a
    # row's group holds columns (c * 32 W + l) * V + e (vector) or
    # ((c * W + w) * V + e) * 32 + t (element)
    warps = p.warps_per_row
    s, i, w, t, e = np.meshgrid(np.arange(p.slabs), np.arange(p.chunks), np.arange(warps),
                                np.arange(32), np.arange(per_chunk), indexing="ij")
    c = s * p.chunks + i
    held = ((c * 32 * warps + 32 * w + t) * per_chunk + e if vector
            else ((c * warps + w) * per_chunk + e) * 32 + t)
    held = held.ravel()[held.ravel() < d]
    assert np.array_equal(np.sort(held), np.arange(d))


def test_launch_plan_fills_the_card_at_few_rows():
    # decode rows take more warps each; prefill and training rows one warp
    assert launch_plan(4, 2048, torch.bfloat16, True) == (ROUTE_VECTOR, 4, 1, 2, 1)
    assert launch_plan(1024, 2048, torch.bfloat16, True) == (ROUTE_VECTOR, 1, 4, 8, 1)
    assert launch_plan(2048, 2048, torch.float32, True) == (ROUTE_VECTOR, 2, 2, 8, 1)
    assert launch_plan(1024, 2048, torch.bfloat16, False).route == ROUTE_ELEMENT
