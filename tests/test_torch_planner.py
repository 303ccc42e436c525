"""The port's planner against the reference's: the plan memo, the
environment default, the quarantine's memo drop, ``autotune`` and
``ReducePlan.hbm_bytes``, and the cost model's staged comparison points and
eq. 13 table.

  * The memo's hits and misses follow ``repro.reduce.plan_cache_info`` over
    the same call sequence; the port's key also holds the operand's device
    type, so a plan made for a CPU operand is never served to a CUDA one.
  * ``ReducePlan.hbm_bytes`` equals the reference's byte for byte on the
    matched backends (cuda_fused / pallas_fused, cuda_hier / pallas_hier,
    mma_torch / mma_jnp, torch / xla): exact integers, no tolerance.
  * ``autotune`` runs on the CPU here (the ``torch`` and ``mma_torch``
    backends, and cuda_fused's plain version for the tiles x lanes sweep),
    at 2^16 elements.
"""

import jax.numpy as jnp
import pytest
import torch

from repro import reduce as RR
from repro.core import cost_model as RC
from repro.reduce import plan as RP
from repro_torch import reduce as R
from repro_torch.core import cost_model as C
from repro_torch.reduce import backends as B
from repro_torch.reduce import plan as P


@pytest.fixture(autouse=True)
def clean_planner():
    R.plan_cache_clear(clear_tuned=True)
    RR.plan_cache_clear(clear_tuned=True)
    yield
    R.plan_cache_clear(clear_tuned=True)
    RR.plan_cache_clear(clear_tuned=True)


def _delta(info_fn, before):
    after = info_fn()
    return after.hits - before.hits, after.misses - before.misses


# (shape, dtype name, kwargs): repeats, an axis spelled two ways, overrides
CALLS = [
    ((4096,), "float32", {}),
    ((4096,), "float32", {}),
    ((4096,), "float32", dict(kind="sumsq")),
    ((64, 512), "float32", dict(axis=1)),
    ((64, 512), "float32", dict(axis=-1)),
    ((64, 512), "float32", dict(axis=(1,))),
    ((4096,), "bfloat16", {}),
    ((4096,), "float32", dict(backend="mma_torch")),
    ((4096,), "float32", dict(tiles_per_block=4)),
    ((4096,), "float32", dict(tiles_per_block=4)),
    ((4096,), "float32", dict(segments=3)),
    ((4096,), "bfloat16", {}),
]
REF_BACKEND = {"mma_torch": "mma_jnp"}


def test_memo_hits_and_misses_match_reference():
    rb, pb = RR.plan_cache_info(), R.plan_cache_info()
    for shape, dt, kw in CALLS:
        rkw = dict(kw)
        if "backend" in rkw:
            rkw["backend"] = REF_BACKEND[rkw["backend"]]
        RR.plan_for(shape, jnp.dtype(dt), **rkw)
        R.plan_for(shape, getattr(torch, dt), **kw)
    assert _delta(R.plan_cache_info, pb) == _delta(RR.plan_cache_info, rb) == (5, 7)
    # a hit returns the same frozen plan
    assert R.plan_for((4096,), torch.float32) is R.plan_for((4096,), torch.float32)


def test_memo_keys_on_the_device_type():
    before = R.plan_cache_info()
    cpu = R.plan_for((2**20,), torch.float32, device="cpu")
    card = R.plan_for((2**20,), torch.float32, device="cuda")
    card0 = R.plan_for((2**20,), torch.float32, device=torch.device("cuda", 0))
    assert (cpu.backend, card.backend) == ("mma_torch", "cuda_fused")
    assert card0 is card
    assert _delta(R.plan_cache_info, before) == (1, 2)
    # scans too
    sb = R.scan_plan_cache_info()
    assert R.scan_plan_for((2**20,), torch.float32, device="cpu").backend == "mma_torch"
    assert R.scan_plan_for((2**20,), torch.float32, device="cuda").backend == "cuda_fused"
    assert R.scan_plan_for((2**20,), torch.float32, device="cuda").backend == "cuda_fused"
    assert _delta(R.scan_plan_cache_info, sb) == (1, 2)


def test_plan_cache_clear_drops_both_memos_and_optionally_the_tuned():
    R.plan_for((4096,), torch.float32)
    R.scan_plan_for((4096,), torch.float32)
    R.autotune((2**16,), torch.float32, backends=("torch",), repeats=1, device="cpu")
    R.plan_for((2**16,), torch.float32, device="cpu")
    R.plan_cache_clear()
    assert R.plan_cache_info().currsize == 0 and R.scan_plan_cache_info().currsize == 0
    assert R.plan_for((2**16,), torch.float32, device="cpu").backend == "torch"  # tuned kept
    R.plan_cache_clear(clear_tuned=True)
    assert R.plan_for((2**16,), torch.float32, device="cpu").backend == "mma_torch"


def test_quarantine_and_reinstate_drop_cached_auto_plans():
    assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "cuda_fused"
    assert R.scan_plan_for((2**20,), torch.float32, device="cuda").backend == "cuda_fused"
    R.quarantine_backend("cuda_fused")
    try:
        assert R.plan_cache_info().currsize == 0 and R.scan_plan_cache_info().currsize == 0
        assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "mma_torch"
        assert R.scan_plan_for((2**20,), torch.float32, device="cuda").backend == "mma_torch"
        # a pin still reaches it (the breaker's half-open probe)
        assert R.plan_for((2**20,), torch.float32, device="cuda",
                          backend="cuda_fused").backend == "cuda_fused"
    finally:
        R.reinstate_backend("cuda_fused")
    assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "cuda_fused"


def test_environment_default_resolution_order(monkeypatch):
    monkeypatch.delenv(R.BACKEND_ENV, raising=False)
    assert R.BACKEND_ENV == "REPRO_TORCH_REDUCE_BACKEND"
    assert R.default_backend() == "auto"
    assert R.backend_for_flags(True, True) == "cuda_fused"
    monkeypatch.setenv(R.BACKEND_ENV, "torch")
    assert R.default_backend() == "torch"  # read at call time
    assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "torch"
    assert R.scan_plan_for((2**20,), torch.float32, device="cuda").backend == "torch"
    assert R.backend_for_flags(True, True) == R.backend_for_flags(False) == "torch"
    R.set_default_backend("mma_torch")
    try:
        assert R.default_backend() == "mma_torch"  # the process default wins
        assert R.backend_for_flags(False) == "mma_torch"
        assert R.plan_for((2**20,), torch.float32, device="cuda").backend == "mma_torch"
    finally:
        R.set_default_backend(None)
    monkeypatch.setenv(R.BACKEND_ENV, "")
    assert R.default_backend() == "auto"  # empty means unset
    # an explicit backend= beats both
    monkeypatch.setenv(R.BACKEND_ENV, "torch")
    assert R.plan_for((2**20,), torch.float32, backend="cuda_hier").backend == "cuda_hier"


def test_autotune_records_a_winner_plan_for_returns():
    timings = {}
    best = R.autotune((2**16,), torch.float32, backends=("torch", "mma_torch"), repeats=2,
                      device="cpu", timings=timings)
    assert set(p.backend for p in timings) == {"torch", "mma_torch"}
    assert timings[best] == min(timings.values())
    before = R.plan_cache_info()
    got = R.plan_for((2**16,), torch.float32, device="cpu")
    again = R.plan_for((2**16,), torch.float32, device="cpu")
    assert got.backend == best.backend and again is got
    assert _delta(R.plan_cache_info, before) == (1, 1)
    # keyed on the device type: a CUDA operand keeps its own auto route
    assert R.plan_for((2**16,), torch.float32, device="cuda").backend == "cuda_fused"
    # the reduction itself takes the tuned plan
    x = torch.randn(2**16)
    assert torch.equal(R.reduce(x), R.reduce(x, plan=got))


def test_autotune_sweeps_tiles_and_lanes_on_the_kernel_backends():
    timings = {}
    best = R.autotune((2**16,), torch.float32, backends=("cuda_fused", "cuda_hier"),
                      tiles_per_block_candidates=(1, 4), lanes_candidates=(1, 2), repeats=1,
                      device="cpu", timings=timings)
    swept = sorted((p.backend, p.tiles_per_block, p.num_lanes) for p in timings)
    assert swept == [("cuda_fused", 1, 1), ("cuda_fused", 1, 2), ("cuda_fused", 4, 1),
                     ("cuda_fused", 4, 2), ("cuda_hier", 1, None), ("cuda_hier", 4, None)]
    got = R.plan_for((2**16,), torch.float32, device="cpu")
    assert (got.backend, got.tiles_per_block, got.num_lanes) == (
        best.backend, best.tiles_per_block, best.num_lanes)
    # explicit fields still beat the tuned entry
    assert R.plan_for((2**16,), torch.float32, device="cpu", tiles_per_block=2,
                      backend="torch").tiles_per_block == 2


class _Raising(B.MmaTorchBackend):
    def __init__(self, name, exc):
        self.name, self.exc = name, exc

    def sum_all(self, x, plan, prologue="identity", epilogue=(), census=False):
        raise self.exc


def test_autotune_skips_refusals_and_propagates_other_errors(monkeypatch):
    monkeypatch.setitem(B._REGISTRY, "refuses", _Raising("refuses", ValueError("refused")))
    monkeypatch.setitem(B._REGISTRY, "breaks",
                        _Raising("breaks", RuntimeError("CUDA kernel failed to launch")))
    best = R.autotune((2**16,), torch.float32, backends=("refuses", "torch"), repeats=1,
                      device="cpu")
    assert best.backend == "torch"
    with pytest.raises(RuntimeError, match="failed to launch"):
        R.autotune((2**16,), torch.float32, backends=("torch", "breaks"), repeats=1,
                   device="cpu")
    with pytest.raises(RuntimeError, match="no candidate ran"):
        R.autotune((2**16,), torch.float32, backends=("refuses",), repeats=1, device="cpu")


def test_autotune_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.autotune((2**16,), torch.float32, backends=("torch",))


MATCHED = [("cuda_fused", "pallas_fused"), ("cuda_hier", "pallas_hier"),
           ("mma_torch", "mma_jnp"), ("torch", "xla")]


def _both(fn_port, fn_ref):
    """Both models' results, or the same exception type from both."""
    try:
        want = fn_ref()
    except ValueError:
        with pytest.raises(ValueError):
            fn_port()
        return None, None
    return fn_port(), want


@pytest.mark.parametrize("lanes,tpb,precision", [(1, 8, "native"), (4, 2, "native"),
                                                 (1, 8, "kahan"), (3, 16, "kahan")])
@pytest.mark.parametrize("backend,ref_backend", MATCHED, ids=[m[0] for m in MATCHED])
def test_hbm_bytes_matches_reference(backend, ref_backend, lanes, tpb, precision):
    plan = R.ReducePlan(backend=backend, num_lanes=lanes, tiles_per_block=tpb,
                        precision=precision)
    ref = RP.ReducePlan(backend=ref_backend, num_cores=lanes, tiles_per_block=tpb,
                        precision=precision)
    checked = 0
    for n in (1000, 2**16 + 3, 2**20):
        for dt in ("float32", "bfloat16", "float16", "int32", "float64"):
            for prologue in ("identity", "square", "moments"):
                for segments in (None, 5):
                    for census in (False, True):
                        for epilogue in (0, 1, 2):
                            kw = dict(segments=segments, prologue=prologue,
                                      epilogue=epilogue, census=census)
                            got, want = _both(
                                lambda: plan.hbm_bytes(n, getattr(torch, dt), **kw),
                                lambda: ref.hbm_bytes(n, jnp.dtype(dt), **kw))
                            if want is None:
                                continue
                            assert dataclasses_eq(got, want), (n, dt, kw, got, want)
                            checked += 1
    assert checked > 400
    # a dtype name works as the dtype
    assert plan.hbm_bytes(4096, "bfloat16") == plan.hbm_bytes(4096, torch.bfloat16)


def dataclasses_eq(got, want) -> bool:
    fields = ("kernel_read", "kernel_write", "stage_read", "stage_write", "combine_read",
              "combine_write", "refetch_read")
    return all(getattr(got, f) == getattr(want, f) for f in fields) and (
        got.launch_io == want.launch_io and got.total == want.total)


@pytest.mark.parametrize("n", [1, 1000, 2**16 + 3, 2**24])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cores,tpb", [(1, 8), (4, 2), (528, 8)])
def test_staged_models_match_reference(n, itemsize, cores, tpb):
    for kahan in (False, True):
        assert dataclasses_eq(
            C.staged_fused_hbm_bytes(n, itemsize, num_cores=cores, tiles_per_block=tpb,
                                     kahan=kahan),
            RC.staged_fused_hbm_bytes(n, itemsize, num_cores=cores, tiles_per_block=tpb,
                                      kahan=kahan))
    assert dataclasses_eq(
        C.staged_sumsq_hbm_bytes(n, itemsize, num_cores=cores, tiles_per_block=tpb),
        RC.staged_sumsq_hbm_bytes(n, itemsize, num_cores=cores, tiles_per_block=tpb))
    for path in ("fused_staged", "sumsq_staged", "parts_2trip"):
        assert dataclasses_eq(
            C.hbm_bytes(path, n, itemsize, num_cores=cores, tiles_per_block=tpb, segments=7,
                        census=8),
            RC.hbm_bytes(path, n, itemsize, num_cores=cores, tiles_per_block=tpb, segments=7,
                         census=8))


def test_model_table_matches_reference():
    assert C.model_table() == RC.model_table()
    ns, ms = (2**8, 2**28), (4, 8, 128)
    assert C.model_table(ns, ms) == RC.model_table(ns, ms)


def test_fused_launch_bytes_is_what_the_port_kernel_moves():
    # one lane: the buffer in, the finished scalar(s) out
    assert C.fused_launch_bytes(2**20, 2).launch_io == 2**21 + 4
    assert C.fused_launch_bytes(2**20, 4, outputs=2).launch_io == 2**22 + 8
    # C lanes: two words a lane written, and read back by the last CTA
    t = C.fused_launch_bytes(2**28, 4, num_lanes=528)
    assert (t.kernel_read, t.kernel_write) == (2**30 + 528 * 8, 4 + 528 * 8)
    # lanes clamp to the blocks, as the launch geometry does
    assert C.fused_launch_bytes(4 * 128 * 128, 4, num_lanes=528,
                                tiles_per_block=1).kernel_write == 4 + 4 * 8
    # the reference's model of the same plan charges (C, m, m) partials
    plan = R.ReducePlan(backend="cuda_fused", num_lanes=528)
    assert plan.hbm_bytes(2**28, torch.float32).kernel_write == 528 * 128 * 128 * 4
    assert plan.hbm_bytes(2**28, torch.float32).kernel_read == t.kernel_read - 528 * 8


def test_plan_module_exports():
    for name in ("plan_cache_info", "plan_cache_clear", "scan_plan_cache_info", "autotune",
                 "count_kernel_launches", "measured_hbm_bytes", "staging_ops",
                 "assert_staging_free", "epilogue_ops", "assert_epilogue_free", "census_ops",
                 "assert_census_free", "launch_records"):
        assert callable(getattr(R, name)), name
    assert P._PLAN_CACHE_SIZE == RP._PLAN_CACHE_SIZE
