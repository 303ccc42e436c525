"""The word route of the port's fused sum (K1) and segmented gather (K8).

Since their redesign the two kernels keep a group's 16-byte load as the
words loaded until those words are the ones-MMA's A operand
(``csrc/reduce_common.cuh``): a bf16 / f16 input at its own compute dtype
is not converted at all, abs clears the sign bits, the census tests the
exponent bits, square unpacks, squares in f32 and packs, and an f32 input
is rounded once per pair (``cvt.rn.bf16x2.f32`` / ``cvt.rn.f16x2.f32``).
The kernels before it took every element through f32 (``to_f32``, then
``to_compute``, the prologue, ``fabsf`` / ``isfinite``, then a pack). These
tests hold the identities that make the two routes give the same MMA
operands, over every 16-bit pattern, and the one-conversion rounding
against the element route on a seeded f32 sample, in numpy, independently
of PyTorch's casts (which are held to the same answers). NaN patterns are
held to stay NaN: the sum of a group with a NaN is NaN either way.

Then the one-lane route of K1 (one CTA writes ``[chain(0 + total),
count]``, no ticket): its plain version against the reference's fused
kernel (interpret mode) on integer-valued inputs, which sum exactly in any
order, so the two agree bitwise, census, chain and the sign of a zero
total included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mma_reduce import ops as RO
from repro_torch.kernels.mma_reduce import ops

EXP = {"bfloat16": 0x7F80, "float16": 0x7C00}  # the exponent field, all ones
SIGN = 0x8000
LARGEST = {"bfloat16": 3.3895314e38, "float16": 65504.0}
ULP_AT_LARGEST = {"bfloat16": 2.0**120, "float16": 32.0}


def _all_patterns():
    return np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def _to_f32(h: np.ndarray, dtype: str) -> np.ndarray:
    """16-bit patterns as f32 values (exact)."""
    if dtype == "bfloat16":
        return (h.astype(np.uint32) << 16).view(np.float32)
    return h.view(np.float16).astype(np.float32)


def _round(v: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values to 16-bit patterns, round to nearest even (the kernels'
    ``__float2bfloat16_rn`` / ``__float2half_rn`` and the pair
    conversions ``cvt.rn.bf16x2.f32`` / ``cvt.rn.f16x2.f32``)."""
    v = np.asarray(v, np.float32)
    if dtype == "float16":
        with np.errstate(over="ignore"):
            return v.astype(np.float16).view(np.uint16)
    u = v.view(np.uint32).astype(np.uint64)
    out = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(v), np.uint16(0x7FC0), out)


def _torch_round(v: np.ndarray, dtype: str) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(getattr(torch, dtype))
    return t.view(torch.int16).numpy().view(np.uint16)


def _same(got: np.ndarray, want: np.ndarray, dtype: str) -> bool:
    """Bitwise equal, NaN patterns only NaN-for-NaN."""
    gn, wn = np.isnan(_to_f32(got, dtype)), np.isnan(_to_f32(want, dtype))
    return bool(np.array_equal(gn, wn) and np.array_equal(got[~gn], want[~wn]))


@pytest.mark.parametrize("identity", ["round_trip", "abs", "census", "square"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_word_route_identities_over_every_pattern(dtype, identity):
    h = _all_patterns()
    v = _to_f32(h, dtype)  # to_f32: the element route's load
    if identity == "round_trip":  # to_compute(to_f32(h)) == h: the loaded word IS the operand
        want = _round(v, dtype)
        assert _same(h, want, dtype)
        assert _same(h, _torch_round(v, dtype), dtype)
    elif identity == "abs":  # clearing the sign bit == fabsf, then the rounding
        got = h & np.uint16(~SIGN & 0xFFFF)
        want = _round(np.abs(v), dtype)
        assert _same(got, want, dtype)
        assert _same(got, _torch_round(np.abs(v), dtype), dtype)
    elif identity == "census":  # the exponent test == not isfinite(to_f32(h))
        got = (h & np.uint16(EXP[dtype])) == EXP[dtype]
        assert np.array_equal(got, ~np.isfinite(v))
        assert int(got.sum()) == 2 * 2 ** (10 if dtype == "float16" else 7)  # +-inf and NaNs
    else:  # square: one rounding of the f32 product == to_compute then pack again
        with np.errstate(over="ignore", invalid="ignore"):
            p = v * v
        once = _round(p, dtype)
        twice = _round(_to_f32(once, dtype), dtype)
        assert _same(once, twice, dtype)
        assert _same(once, _torch_round(p, dtype), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_pair_conversion_of_f32_is_the_element_route(dtype):
    """f32 input at bf16 / f16 compute: one conversion per pair gives the
    words that ``to_compute`` followed by ``pack_bf16`` / ``pack_f16`` gave
    (rounding an exactly representable value changes nothing), and the
    census on those words counts what ``isfinite`` of the compute-cast
    value counted -- an f32 past the dtype's largest finite value too."""
    rng = np.random.default_rng(19)
    top, ulp = LARGEST[dtype], ULP_AT_LARGEST[dtype]
    tie = np.float32(top + ulp / 2)  # halfway to the next (infinite) value: rounds to inf
    with np.errstate(over="ignore"):
        near = np.array([top, tie, np.nextafter(tie, np.float32(0)),
                         np.nextafter(tie, np.float32(np.inf)), top + ulp, 3.4028235e38, np.inf,
                         np.nan, 0.0, -0.0, 1e-45, 6e-8], np.float32)
    lim = min(top * 1.001, 3.4e38)
    sample = np.concatenate([
        rng.standard_normal(1 << 16).astype(np.float32) * rng.choice([1e-6, 1.0, 3e4], 1 << 16),
        rng.uniform(-lim, lim, 4096).astype(np.float32), near, -near])
    one = _round(sample, dtype)  # cvt.rn.{bf16,f16}x2.f32 of the f32 pair
    two = _round(_to_f32(_round(sample, dtype), dtype), dtype)  # to_compute, then the pack
    assert _same(one, two, dtype)
    assert _same(one, _torch_round(sample, dtype), dtype)
    with np.errstate(over="ignore"):
        cast = _to_f32(_torch_round(sample, dtype), dtype)
    counted = (one & np.uint16(EXP[dtype])) == EXP[dtype]
    assert np.array_equal(counted, ~np.isfinite(cast))
    finite_f32 = np.isfinite(sample)
    assert bool(np.any(counted & finite_f32))  # finite in f32, infinite after the rounding


ONE_LANE_N = [1, 7, 2048, 131072, 131073]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", ONE_LANE_N)
def test_one_lane_route_plain_matches_reference(n, compute):
    """The plain version of K1's one-lane launch (``num_lanes=1``; at n =
    131073 two blocks in one lane) against the reference's fused kernel:
    integer values sum exactly in any order, so total, census count and
    chained total agree bitwise; a total of -0.0 values is +0.0 in both."""
    rng = np.random.default_rng(n)
    x = rng.integers(-8, 9, n).astype(np.float32)
    if n > 2:
        x[n // 2] = np.nan
    chain = (("scale", 0.5), ("add_eps", 3.0))
    cd_t, cd_j = getattr(torch, compute), getattr(jnp, compute)
    for v, kw in ((x, dict(census=True, epilogue=chain)),
                  (np.nan_to_num(x), dict(prologue="square")),
                  (np.full(n, -0.0, np.float32), dict(census=True))):
        got = ops.mma_sum_fused(torch.from_numpy(v), compute_dtype=cd_t, num_lanes=1, **kw)
        want = RO.mma_sum_pallas(jnp.asarray(v), mode="fused", num_cores=1, compute_dtype=cd_j,
                                 interpret=True, **kw)
        got = np.array([float(g) for g in (got if kw.get("census") else (got,))], np.float32)
        want = np.array([float(w) for w in (want if kw.get("census") else (want,))], np.float32)
        assert np.array_equal(got, want, equal_nan=True), (kw, got, want)
        real = ~np.isnan(want)  # a NaN's sign bit is no part of the result
        assert np.array_equal(np.signbit(got[real]), np.signbit(want[real]))
    assert ops.lane_geometry(n, 1)[1] == 1
