"""The card's reduction roofline and the reference's last public names in
the port.

  * ``cost_model.gpu_reduction_roofline``: at m = 128 its tensor-core FLOPs
    equal the reference's MMA-FLOP count (``tpu_reduction_roofline(n).mxu_s
    * PEAK_BF16_FLOPS``) to 1e-12 relative; ``hbm_s`` is n b / 3.35e12; the
    CUDA-core term, the cold bound and the bandwidth-neutral verdict follow
    their definitions; the figures ``launch.reduce_demo`` prints at 2^28.
  * ``core``'s deprecated shims ``mma_sum_diff``, ``mma_sum_axis`` and
    ``global_norm_sq_mma`` against the reference's on seeded numpy inputs,
    within ``tests/harness.py``'s budgets (``budget_for``, ``mass_tol``);
    ``mma_sum_diff``'s gradient is the broadcast cotangent, exactly; each
    shim warns, as the reference's.
  * ``layers.rope(rot_dim=)`` against the reference's, to 1e-6.
  * ``params.split`` / ``stack_init``, ``mla.cfg_dtype``, ``reduce.api.Axis``.
  * The dry run's ``--skip-existing`` keeps a cell file it finds (a marker
    written into the file survives), and reruns a cell of another depth.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RCORE
from repro.core import cost_model as RC
from repro.models import layers as RL
from repro_torch import core as CORE
from repro_torch.core import cost_model as C
from repro_torch.launch import dryrun
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models import params as P
from repro_torch.reduce import api

from harness import budget_for, mass_tol

NS = (2**10, 2**16, 2**20, 2**28)


@pytest.mark.parametrize("n", NS)
def test_tensor_flops_are_the_references(n):
    want = RC.tpu_reduction_roofline(n).mxu_s * RC.PEAK_BF16_FLOPS
    got = C.gpu_reduction_roofline(n, m=128)
    assert got.tensor_flops == pytest.approx(want, rel=1e-12)
    assert got.tensor_core_s == pytest.approx(want / C.BF16_TENSOR_FLOPS, rel=1e-12)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("m", [16, 128])
def test_terms_follow_their_definitions(n, b, m):
    r = C.gpu_reduction_roofline(n, b, m=m)
    assert (r.n, r.bytes_per_el, r.m) == (n, b, m)
    assert r.hbm_s == n * b / 3.35e12
    assert r.tensor_flops == C.reduction_mma_flops(n, m)
    assert r.cuda_core_s == pytest.approx(n / 33.5e12 + 10 * np.log2(n) / 1.98e9, rel=1e-12)
    assert r.cold_bound_s == max(r.hbm_s, r.tensor_core_s)
    assert r.fused_speedup == r.cuda_core_s / r.tensor_core_s
    assert r.tensor_core_bandwidth_neutral == (r.tensor_core_s <= 1.15 * r.hbm_s)


def test_the_figures_at_2_28():
    """The demo's table at n = 2^28 (the arithmetic PERF.md predicts from): tensor cores
    ~139 us at m = 128 and ~17 at m = 16, the streams 160.3 / 320.5 us,
    the CUDA cores ~8; bandwidth-neutral either way for cold data."""
    n = 2**28
    r128, r16 = C.gpu_reduction_roofline(n, m=128), C.gpu_reduction_roofline(n, m=16)
    assert r128.tensor_core_s * 1e6 == pytest.approx(138.976, abs=1e-3)
    assert r16.tensor_core_s * 1e6 == pytest.approx(17.439, abs=1e-3)
    assert r128.hbm_s * 1e6 == pytest.approx(160.260, abs=1e-3)
    assert C.gpu_reduction_roofline(n, 4).hbm_s * 1e6 == pytest.approx(320.520, abs=1e-3)
    assert r128.cuda_core_s * 1e6 == pytest.approx(8.154, abs=1e-3)
    assert r128.tensor_core_bandwidth_neutral and r16.tensor_core_bandwidth_neutral
    assert r128.cold_bound_s == r128.hbm_s
    # the reduce demo's table: n x m rows, bf16 and f32
    from repro_torch.launch import reduce_demo

    rows = reduce_demo.roofline_table()
    assert [(n_, m_) for n_, m_, _, _ in rows] == [(n_, m_) for n_ in reduce_demo.ROOFLINE_NS
                                                   for m_ in reduce_demo.ROOFLINE_MS]
    assert all(r2.bytes_per_el == 2 and r4.bytes_per_el == 4 for _, _, r2, r4 in rows)


def _numpy(seed: int, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


@pytest.mark.parametrize("n,m", [(1000, 128), (70000, 128), (5000, 16)])
def test_mma_sum_diff_and_its_gradient(n, m):
    x = _numpy(n, (n,))
    want = _quiet(RCORE.mma_sum_diff, jnp.asarray(x), m)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _quiet(CORE.mma_sum_diff, xt, m)
    assert abs(float(got.detach()) - float(want)) <= budget_for(x, "sum")
    g = torch.tensor(0.75)
    (gx,) = torch.autograd.grad(got, xt, g)
    assert gx.shape == xt.shape and bool(torch.all(gx == 0.75))
    want_g = jax.grad(lambda a: _quiet(RCORE.mma_sum_diff, a, m) * 0.75)(jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("shape,axis", [((6, 5, 40), 2), ((6, 5, 40), (0, 2)),
                                        ((3, 300), -1), ((4, 3, 2), (0, 1, 2))])
def test_mma_sum_axis(shape, axis):
    x = _numpy(7, shape)
    want = np.asarray(_quiet(RCORE.mma_sum_axis, jnp.asarray(x), axis))
    got = _quiet(CORE.mma_sum_axis, torch.from_numpy(x), axis).numpy()
    assert got.shape == want.shape
    axes = (axis,) if isinstance(axis, int) else axis
    mass = np.abs(x).sum(axis=axes)
    assert np.all(np.abs(got - want) <= 4e-3 * np.maximum(mass, 1.0))


def test_global_norm_sq_mma():
    shapes = [(64, 33), (1000,), (5, 7, 9), (16384 + 3,)]
    leaves = [_numpy(i, s) for i, s in enumerate(shapes)]
    want = float(_quiet(RCORE.global_norm_sq_mma, {f"l{i}": jnp.asarray(a)
                                                  for i, a in enumerate(leaves)}))
    got = float(_quiet(CORE.global_norm_sq_mma, {f"l{i}": torch.from_numpy(a)
                                                 for i, a in enumerate(leaves)}))
    flat = np.concatenate([a.reshape(-1) for a in leaves])
    assert abs(got - want) <= budget_for(flat, "sumsq", compute_dtype="float32")
    assert abs(got - float((flat.astype(np.float64) ** 2).sum())) <= mass_tol(flat**2, 2e-4)


@pytest.mark.parametrize("name", ["mma_sum", "mma_mean", "mma_sum_axis", "mma_sum_diff",
                                  "classic_tree_sum", "row_sum_mma", "row_moments_mma",
                                  "global_norm_sq_mma"])
def test_core_shims_warn_and_delegate(name):
    assert name in dir(CORE) and hasattr(RCORE, name)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    args = {"mma_sum_axis": (x, 1), "global_norm_sq_mma": ({"a": x},)}.get(name, (x,))
    with pytest.warns(DeprecationWarning, match=f"repro_torch.core.{name} is deprecated"):
        out = getattr(CORE, name)(*args)
    from repro_torch.core import mma_reduce

    direct = getattr(mma_reduce, name)(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    direct if isinstance(direct, tuple) else (direct,)):
        assert torch.equal(a, b)
    assert CORE.DEFAULT_M == 128 and CORE.ReductionTrace is mma_reduce.ReductionTrace
    assert CORE.cost_model is C and CORE.reduce.reduce is api.reduce


@pytest.mark.parametrize("rot_dim", [None, 8, 16, 32])
def test_rope_rot_dim(rot_dim):
    x = _numpy(3, (2, 9, 3, 32))
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + 5
    want = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rot_dim))
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, rot_dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if rot_dim is not None and rot_dim < 32:
        np.testing.assert_array_equal(got[..., rot_dim:], x[..., rot_dim:])


def test_split_and_stack_init():
    gens = P.split(torch.Generator().manual_seed(3), 4)
    again = P.split(torch.Generator().manual_seed(3), 4)
    draws = [torch.randn(5, generator=g) for g in gens]
    assert all(torch.equal(a, torch.randn(5, generator=g)) for a, g in zip(draws, again))
    assert len({tuple(d.tolist()) for d in draws}) == 4  # independent streams

    def init(g):
        return {"w": P.dense_init(g, 6, 3, torch.float32, "cpu"), "n": P.norm_init(
            "rmsnorm", 3, torch.float32, "cpu")}

    stacked = P.stack_init(init, torch.Generator().manual_seed(1), 5)
    assert stacked["w"]["w"].shape == (5, 6, 3) and stacked["n"]["scale"].shape == (5, 3)
    unstacked = [init(g) for g in P.split(torch.Generator().manual_seed(1), 5)]
    assert all(torch.equal(stacked["w"]["w"][i], u["w"]["w"]) for i, u in enumerate(unstacked))


def test_mla_cfg_dtype_and_axis():
    from repro.models import mla as RMLA
    from repro_torch.configs import get_arch

    for dtype in ("bfloat16", "float32"):
        cfg = get_arch("minicpm3-4b", tiny=True)
        cfg = type(cfg)(**{**cfg.__dict__, "dtype": dtype})
        assert str(mla.cfg_dtype(cfg)).replace("torch.", "") == str(RMLA.cfg_dtype(cfg))
    import typing

    assert set(typing.get_args(api.Axis)) >= {int, type(None)}


def test_skip_existing_keeps_a_cell(tmp_path, capsys):
    argv = ["--arch", "olmo-1b", "--shape", "train_4k", "--mesh", "2x2", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    path = tmp_path / "olmo-1b__train_4k__2x2.json"
    rec = json.loads(path.read_text())
    assert rec["status"] in dryrun.KEPT
    rec["marker"] = "kept"
    path.write_text(json.dumps(rec))
    capsys.readouterr()
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "[keep] olmo-1b x train_4k x 2x2" in capsys.readouterr().out
    assert json.loads(path.read_text())["marker"] == "kept"
    # a cell of another depth is run again
    assert dryrun.main(argv + ["--skip-existing", "--layers", "2"]) == 0
    assert "marker" not in json.loads(path.read_text())
