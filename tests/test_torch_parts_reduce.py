"""Port parity: ``repro_torch.reduce.reduce_tree`` with the in-launch
census, on ``cuda_fused`` (the parts kernel; its plain version on the CPU)
and on ``mma_torch``, against ``repro.reduce.reduce_tree`` on
``pallas_fused`` (the reference's parts kernel, interpret mode). Also the
row reductions of ``repro_torch.reduce.reduce`` against the reference.

Leaves: ragged sizes (tails of the 16384-element tile), an empty leaf, and
NaN/Inf planted in two leaves; epilogue chains ``[(), ("clip_coeff",
1.0)]``. Census counts must be EQUAL (exact integers). Sums are f32 sums of
at most ~5e4 terms taken in different orders, so they agree to a small
multiple of f32 epsilon times the summed MASS (the sum of the terms'
magnitudes), not times the result, which may cancel: tolerance
1e-6 * mass (observed below 1e-8 * mass).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import reduce as RR
from repro_torch import reduce as R
from repro_torch.kernels import mma_reduce
from repro_torch.models.convert import tensor_from_numpy

SIZES = (100, 0, 20000, 16384, 3 * 16384 + 5)


def _leaves(poison: bool, seed=0):
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal(n).astype(np.float32) for n in SIZES]
    if poison:
        leaves[2][7] = np.nan
        leaves[4][-1] = np.inf
        leaves[4][3] = -np.inf
    return leaves


def _close(got, want, mass):
    np.testing.assert_allclose(
        np.asarray(got.numpy(), np.float64), np.asarray(want, np.float64),
        rtol=0, atol=1e-6 * mass, equal_nan=True,
    )


def _mass(leaves, square):
    fin = [np.where(np.isfinite(x), x, 0).astype(np.float64) for x in leaves]
    return float(sum(np.sum(x * x if square else np.abs(x)) for x in fin))


@pytest.mark.parametrize("backend", ["cuda_fused", "mma_torch"])
@pytest.mark.parametrize("kind", ["sumsq", "norm2", "sum"])
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-inf"])
def test_reduce_tree_census_matches_reference(backend, kind, poison):
    leaves = _leaves(poison)
    epi = [(), ("clip_coeff", 1.0)]
    want_per, want_tot, want_cnt = RR.reduce_tree(
        [jnp.asarray(x) for x in leaves], kind, backend="pallas_fused",
        epilogue=epi, return_per_leaf=True, census=True,
    )
    per, tot, cnt = R.reduce_tree(
        [torch.from_numpy(x) for x in leaves], kind, backend=backend,
        epilogue=epi, return_per_leaf=True, census=True,
    )
    assert per.shape == (len(SIZES),) and tot.shape == (2,) and cnt.shape == (len(SIZES) + 1,)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    mass = _mass(leaves, kind != "sum")
    _close(per, want_per, mass)
    _close(tot, want_tot, mass)


def test_guarded_logit_stat_layout_matches_reference():
    """The serving statistic: one leaf per slot, sumsq + census."""
    from repro.runtime.serving import guarded_logit_stat as ref_stat
    from repro_torch.runtime.serving import guarded_logit_stat

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 1, 1000)).astype(np.float32)
    logits[1, 0, 5] = np.nan
    ws, wc = ref_stat(jnp.asarray(logits), backend="pallas_fused")
    gs, gc = guarded_logit_stat(torch.from_numpy(logits), backend="cuda_fused")
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    _close(gs, ws, _mass([logits], True))


def test_parts_all_empty_and_layout():
    assert mma_reduce.parts_layout([0, 5, 0, 16385], 16384) == ((1, 0, 1, 5), (3, 1, 2, 16385))
    out = mma_reduce.mma_sum_parts(
        [torch.zeros(0), torch.zeros(0)], prologue="square",
        total_chains=((), (("clip_coeff", 1.0),)), census=True,
    )
    # zero totals, chains of a zero total, zero counts
    np.testing.assert_array_equal(out.numpy(), [0, 0, 0, 1, 0, 0, 0])


def test_parts_bf16_compute_not_ported():
    # bf16 and f16 compute are ported (tests/test_torch_reduce_many.py holds
    # them against the reference); a compute dtype the kernel has no form
    # for still raises
    assert float(mma_reduce.mma_sum_parts([torch.ones(4)], compute_dtype=torch.bfloat16)[0]) == 4
    with pytest.raises(ValueError):
        mma_reduce.mma_sum_parts([torch.ones(4)], compute_dtype=torch.float64)


@pytest.mark.parametrize("backend", ["torch", "mma_torch", "cuda_fused"])
@pytest.mark.parametrize("kind", ["sum", "sumsq", "moments"])
def test_reduce_rows_match_reference(backend, kind):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 7, 300)) * 2).astype(np.float32)
    ref_backend = {"torch": "xla", "mma_torch": "mma_jnp", "cuda_fused": "pallas_fused"}[backend]
    want = RR.reduce(jnp.asarray(x), axis=-1, kind=kind, backend=ref_backend)
    got = R.reduce(tensor_from_numpy(x), -1, kind, backend=backend)
    row_mass = {  # the largest row's mass: each output is one row's sum
        "sum": float(np.max(np.sum(np.abs(x), -1))),
        "sumsq": float(np.max(np.sum(x * x, -1))),
    }
    if kind == "moments":
        _close(got[0], want[0], row_mass["sum"])
        _close(got[1], want[1], row_mass["sumsq"])
    else:
        _close(got, want, row_mass[kind])


@pytest.mark.parametrize("backend", ["torch", "mma_torch", "cuda_fused"])
def test_default_axis_is_full_reduction(backend):
    # reduce(x) with no axis is a full reduction in both packages
    x = np.random.default_rng(6).standard_normal((5, 300)).astype(np.float32)
    ref_backend = {"torch": "xla", "mma_torch": "mma_jnp", "cuda_fused": "pallas_fused"}[backend]
    want = RR.reduce(jnp.asarray(x), backend=ref_backend)
    got = R.reduce(torch.from_numpy(x), backend=backend)
    assert tuple(got.shape) == tuple(want.shape) == ()
    # both sides round the same elements at the same width; only the f32
    # summation order differs: 8e-6 x mass
    _close(got, want, float(np.abs(x).sum()) * 8)


@pytest.mark.parametrize("mma", [True, False])
def test_backend_for_flags_matches_reference(mma):
    # the flags map onto the counterpart of the reference's backend --
    # (mma, kernels) as the reference's (mma, use_pallas) -- and a process
    # default overrides them in both packages
    names = {"xla": "torch", "mma_jnp": "mma_torch", "pallas_fused": "cuda_fused"}
    for kernels in (False, True):
        assert R.backend_for_flags(mma, kernels) == names[RR.backend_for_flags(mma, kernels)]
    assert R.backend_for_flags(mma) == names[RR.backend_for_flags(mma)]
    try:
        R.set_default_backend("cuda_fused")
        assert R.backend_for_flags(mma) == "cuda_fused"
        assert R.backend_for_flags(mma, False) == "cuda_fused"
    finally:
        R.set_default_backend(None)
    assert R.backend_for_flags(mma) == names[RR.backend_for_flags(mma)]
