"""Port parity: ``repro_torch.kernels.matmul_stats`` (K11, the matmul with
its fused row moments) against the reference's Pallas kernel, run in
interpret mode on the CPU as ``tests/test_kernels_matmul_stats.py`` runs
it, and against the reference's oracle.

Inputs come from numpy with a seed and reach both sides bit-identically
(bf16 and f16 through ``tensor_from_numpy``). On the CPU the port runs the
kernel's plain version: the same bf16 operands, f32 accumulation over K
blocks, moments taken from the f32 tile and folded over the column tiles
in order.

Tolerances: at f32 input the reference test's own (Y atol 1e-4, s atol
1e-2, ss rtol 1e-3 / atol 1e-2). At bf16 and f16 input Y is stored in x's
dtype: one ulp of that dtype. The moments are those of the f32
accumulator, held within 1e-5 of each row's sum of |y| (sum) and 1e-5 of
its sum of y^2 (sum of squares) plus 1e-2: f32 sums of the same products
in other orders. Sums of the stored, rounded Y miss that at bf16 and at
f16, and the test shows they do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _optional_hypothesis import hypothesis, st

from repro.kernels.matmul_stats import matmul_stats as ref_matmul_stats
from repro.kernels.matmul_stats import matmul_stats_ref as ref_oracle
from repro_torch.kernels import common, matmul_stats
from repro_torch.kernels.matmul_stats import matmul_stats_plain, matmul_stats_ref, ops
from repro_torch.models.convert import tensor_from_numpy

# The reference test's shapes and tiles
SHAPES = [(8, 16, 32), (64, 128, 256), (100, 300, 500), (256, 512, 384), (33, 65, 129)]
TILES = dict(bm=64, bn=128, bk=128)


def _operands(m, k, n, dtype="float32", seed=0, scale=0.3):
    r = np.random.RandomState(seed)
    x = jnp.asarray(r.randn(m, k).astype(np.float32) * scale).astype(dtype)
    w = jnp.asarray(r.randn(k, n).astype(np.float32) * scale).astype(dtype)
    return x, w, tensor_from_numpy(np.asarray(x)), tensor_from_numpy(np.asarray(w))


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matches_reference_kernel(m, k, n):
    xj, wj, xt, wt = _operands(m, k, n)
    y, s, ss = matmul_stats(xt, wt, **TILES)
    yr, sr, ssr = ref_matmul_stats(xj, wj, **TILES)
    assert y.dtype == torch.float32 and s.dtype == ss.dtype == torch.float32
    assert y.shape == (m, n) and s.shape == ss.shape == (m,)
    np.testing.assert_allclose(_np(y), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(_np(s), np.asarray(sr), atol=1e-2)
    np.testing.assert_allclose(_np(ss), np.asarray(ssr), rtol=1e-3, atol=1e-2)
    # and the reference's oracle, with the same tolerances
    yo, so, sso = ref_oracle(xj, wj)
    np.testing.assert_allclose(_np(y), np.asarray(yo), atol=1e-4)
    np.testing.assert_allclose(_np(s), np.asarray(so), atol=1e-2)
    np.testing.assert_allclose(_np(ss), np.asarray(sso), rtol=1e-3, atol=1e-2)


def test_block_shape_invariance():
    r = np.random.RandomState(0)
    xt = torch.from_numpy(r.randn(128, 256).astype(np.float32))
    wt = torch.from_numpy(r.randn(256, 512).astype(np.float32))
    a = matmul_stats(xt, wt, bm=128, bn=512, bk=256)
    b = matmul_stats(xt, wt, bm=64, bn=128, bk=64)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4, atol=1e-2)


@hypothesis.settings(max_examples=10, deadline=None)
@hypothesis.given(m=st.integers(1, 96), k=st.integers(2, 200), n=st.integers(2, 200),
                  seed=st.integers(0, 2**31 - 1))
def test_property_moments_consistent(m, k, n, seed):
    """ss >= s^2 / N (Cauchy-Schwarz), and both match the reference's
    oracle."""
    xj, wj, xt, wt = _operands(m, k, n, seed=seed, scale=0.2)
    _, s, ss = matmul_stats(xt, wt, bm=32, bn=64, bk=64)
    s64, ss64 = s.double().numpy(), ss.double().numpy()
    assert (ss64 + 1e-4 >= s64**2 / n).all()
    _, so, sso = ref_oracle(xj, wj)
    np.testing.assert_allclose(s64, np.asarray(so), atol=1e-2)
    np.testing.assert_allclose(ss64, np.asarray(sso), rtol=1e-3, atol=1e-2)


def _moment_tols(y32):
    """Per row: 1e-5 of sum |y| for s, 1e-5 of sum y^2 for ss, plus 1e-2."""
    a = np.abs(np.asarray(y32, np.float64))
    return 1e-5 * a.sum(-1) + 1e-2, 1e-5 * (a * a).sum(-1) + 1e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(64, 256, 256), (33, 65, 129)])
def test_low_precision_input_moments_of_the_accumulator(dtype, m, k, n):
    """bf16 / f16 x and w: Y keeps x's dtype, and s and ss are those of the
    f32 accumulator (the reference's), which a sum of the stored Y misses."""
    xj, wj, xt, wt = _operands(m, k, n, dtype, scale=1.0)
    y, s, ss = matmul_stats(xt, wt, **TILES)
    yr, sr, ssr = ref_matmul_stats(xj, wj, **TILES)
    assert y.dtype == xt.dtype and s.dtype == torch.float32
    assert str(yr.dtype) == dtype
    ulp = 2.0**-8 if dtype == "bfloat16" else 2.0**-11
    yr32 = np.asarray(yr, np.float32)
    assert np.all(np.abs(_np(y) - yr32) <= 2 * ulp * np.abs(yr32) + 1e-6)
    y32 = np.asarray(ref_oracle(xj.astype(jnp.float32), wj.astype(jnp.float32))[0])
    tol_s, tol_ss = _moment_tols(y32)
    assert np.all(np.abs(_np(s) - np.asarray(sr)) <= tol_s)
    assert np.all(np.abs(_np(ss) - np.asarray(ssr)) <= tol_ss)
    # the tolerance has teeth: the moments of the rounded, stored Y fail it
    # (at bf16, 64 x 256 x 256: the sum 16x over, the sum of squares 60x)
    rounded = _np(y).astype(np.float64)
    off_s = np.abs(rounded.sum(-1) - np.asarray(sr, np.float64))
    off_ss = np.abs((rounded * rounded).sum(-1) - np.asarray(ssr, np.float64))
    assert np.any(off_s > tol_s) and np.any(off_ss > tol_ss)


def test_mixed_input_dtypes_follow_x():
    xj, _, xt, _ = _operands(20, 48, 40, "float16")
    _, wj, _, wt = _operands(20, 48, 40, "float32", seed=1)
    y, s, ss = matmul_stats(xt, wt, bm=16, bn=16, bk=16)
    yr, sr, ssr = ref_matmul_stats(xj, wj, bm=16, bn=16, bk=16)
    assert y.dtype == torch.float16
    np.testing.assert_allclose(_np(y), np.asarray(yr, np.float32), rtol=2.0**-10, atol=1e-6)
    np.testing.assert_allclose(_np(s), np.asarray(sr), atol=1e-2)
    np.testing.assert_allclose(_np(ss), np.asarray(ssr), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("m,k,n", [(1, 2, 2), (100, 300, 500), (33, 65, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_the_oracle(m, k, n, dtype):
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dtype)
    w = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(dtype)
    y, s, ss = matmul_stats_plain(x, w, bm=8, bn=64, bk=32)
    yo, so, sso = matmul_stats_ref(x, w)
    assert y.dtype == yo.dtype == dtype
    ulp = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-22
    assert bool(torch.all((y.float() - yo.float()).abs() <= 2 * ulp * yo.float().abs() + 1e-5))
    yf = common.bf16_round(x.float()) @ common.bf16_round(w.float())
    tol_s, tol_ss = _moment_tols(yf.numpy())
    assert np.all(np.abs((s - so).double().numpy()) <= tol_s)
    assert np.all(np.abs((ss - sso).double().numpy()) <= tol_ss)


@pytest.mark.parametrize("call,exc,match", [
    (lambda x, w: matmul_stats(x[0], w), ValueError, "2-D"),
    (lambda x, w: matmul_stats(x, w[:-1]), ValueError, "K = 16"),
    (lambda x, w: matmul_stats(x.double(), w), TypeError, "x is torch.float64"),
    (lambda x, w: matmul_stats(x, w.to(torch.int32)), TypeError, "w is torch.int32"),
    (lambda x, w: matmul_stats(x, w, bm=0), ValueError, "bm must be a positive int"),
    (lambda x, w: matmul_stats(x, w, bn=-4), ValueError, "bn must be a positive int"),
    (lambda x, w: matmul_stats(x, w, bk=1.5), ValueError, "bk must be a positive int"),
])
def test_argument_errors(call, exc, match):
    x, w = torch.ones(8, 16), torch.ones(16, 4)
    with pytest.raises(exc, match=match):
        call(x, w)


def test_cpu_path_counts_no_launch_and_refuses_grad():
    x, w = torch.randn(4, 32), torch.randn(32, 8)
    before = common.launch_counts()
    matmul_stats(x, w)
    assert common.launch_counts() == before
    with pytest.raises(RuntimeError, match="not differentiable"):
        matmul_stats(x, w.requires_grad_(True))


# --------------------------- the kernel's load routes ---------------------------


@pytest.mark.parametrize("xdt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("k,n", [(8192, 2048), (8190, 2048), (64, 100), (3, 5), (0, 8)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_load_routes(xdt, wdt, k, n, offset):
    # TMA takes a 16-byte aligned base and rows of a multiple of 16 bytes;
    # bf16 then goes straight into the swizzled tile, f32 and f16 through
    # the producer's cast; anything else is loaded element by element
    xdt, wdt = getattr(torch, xdt), getattr(torch, wdt)
    x = torch.zeros((4 * max(k, 1) + 16,), dtype=xdt)[offset:offset + 4 * k].view(4, k)
    w = torch.zeros((k * n + 16,), dtype=wdt)[:k * n].view(k, n)
    rx, rw = ops.load_routes(x, w)
    x_ok = x.data_ptr() % 16 == 0 and k * x.element_size() % 16 == 0
    w_ok = w.data_ptr() % 16 == 0 and n * w.element_size() % 16 == 0
    fast = {torch.bfloat16: ops.ROUTE_TMA, torch.float32: ops.ROUTE_CAST,
            torch.float16: ops.ROUTE_CAST}
    assert rx == (fast[xdt] if x_ok else ops.ROUTE_ELEM)
    assert rw == (fast[wdt] if w_ok else ops.ROUTE_ELEM)
    # a 2-byte offset or K = 8190 always leaves X to the element loads at 16-bit widths
    if xdt != torch.float32 and k and (offset or k == 8190):
        assert rx == ops.ROUTE_ELEM


def test_load_route_by_address_and_row_bytes():
    assert ops.load_route(torch.bfloat16, 4096, 8192) == ops.ROUTE_TMA
    assert ops.load_route(torch.bfloat16, 4098, 8192) == ops.ROUTE_ELEM
    assert ops.load_route(torch.bfloat16, 4096, 8190) == ops.ROUTE_ELEM
    assert ops.load_route(torch.float32, 4096, 8190) == ops.ROUTE_ELEM
    assert ops.load_route(torch.float32, 4096, 8188) == ops.ROUTE_CAST
    assert ops.load_route(torch.float16, 4112, 8) == ops.ROUTE_CAST
    assert ops.load_route(torch.float16, 4104, 8) == ops.ROUTE_ELEM
