"""The launch meter (``repro_torch.reduce.inspect``) on the CPU.

The kernel wrappers' plain versions run on CPU tensors; with
``include_plain`` the meter counts them as their kernels' calls, with the
bytes the launch would move. The staging,
epilogue and census audits watch the aten ops outside the wrappers. The
byte counts are exact: the meter against ``ReducePlan.hbm_bytes(...)
.launch_io`` (the hierarchy, the parts kernel, the fused kernel's one-lane
in-launch finish) and against ``cost_model.fused_launch_bytes`` (the fused
kernel's lanes folded in its launch).
"""

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.core import cost_model as C
from repro_torch.kernels import common

N = 2**17 + 77  # a ragged tail


def _x(dtype=torch.float32, n=N, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dtype)


def _leaves(dtype=torch.float32):
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in ((300, 70), (5000,), (7, 9), (40, 40, 3))]


def _only(counts):
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_kernel_launches_on_the_three_entries(dtype):
    x = _x(dtype)
    _, counts = R.count_kernel_launches(R.reduce, x, backend="cuda_fused", include_plain=True)
    assert _only(counts) == {"mma_sum_fused": 1}
    _, counts = R.count_kernel_launches(R.reduce, x, kind="moments", backend="cuda_fused",
                                        include_plain=True)
    assert _only(counts) == {"mma_moments_fused": 1}
    _, counts = R.count_kernel_launches(R.reduce, x, backend="cuda_hier", include_plain=True)
    assert _only(counts) == {"tile_partials": 2}  # ceil(N / 128^2) = 9 partials, then 1
    _, counts = R.count_kernel_launches(R.reduce_many, _leaves(dtype), backend="cuda_fused",
                                        include_plain=True)
    assert _only(counts) == {"mma_sum_parts": 1}
    _, counts = R.count_kernel_launches(R.reduce_tree, _leaves(dtype), kind="norm2",
                                        backend="cuda_fused", include_plain=True)
    assert _only(counts) == {"mma_sum_parts": 1}
    # the non-kernel backends call no wrapper
    _, counts = R.count_kernel_launches(R.reduce, x, backend="mma_torch", include_plain=True)
    assert _only(counts) == {}
    # on the CPU nothing is launched: every call is a plain-version call
    _, records = R.launch_records(R.reduce, x, backend="cuda_fused")
    assert [r.route for r in records] == ["plain"]
    assert common.launch_counts()["mma_sum_fused"] == 0


def test_count_kernel_launches_past_128_arrays_takes_the_gather():
    arrays = [_x(n=300 + i, seed=i) for i in range(130)]
    _, counts = R.count_kernel_launches(R.reduce_many, arrays, backend="cuda_fused",
                                        include_plain=True)
    assert _only(counts) == {"mma_sum_segments": 1}


def test_count_kernel_launches_refuses_plain_calls_unless_asked():
    # on the card a plain-version call means an operand was on the CPU: it
    # launched nothing, and a count of launches must not take it for one
    with pytest.raises(RuntimeError, match="plain versions ran in place of kernels"):
        R.count_kernel_launches(R.reduce, _x(), backend="cuda_fused")
    # a launch is counted where it is noted, and only there: once, with no
    # plain call beside it, the count needs no include_plain
    wrapper = common.KERNEL_WRAPPERS["mma_sum_fused"]

    def launched_once():
        common.record_io(wrapper, (16, 4))
        return wrapper.launches

    inside, counts = R.count_kernel_launches(launched_once)
    assert inside == 1 and _only(counts) == {"mma_sum_fused": 1}
    _, records = R.launch_records(launched_once)
    assert [(r.route, r.read_bytes, r.write_bytes) for r in records] == [("kernel", 16, 4)]
    # the bytes are read only while a meter is open
    common.record_io(wrapper, lambda: pytest.fail("bytes computed with no meter open"))


def test_count_kernel_launches_propagates_errors():
    with pytest.raises(ValueError, match="unknown kind"):
        R.count_kernel_launches(R.reduce, _x(), kind="nope", backend="cuda_fused")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_staging_free_on_the_kernel_routes(dtype):
    x = _x(dtype)
    R.assert_staging_free(R.reduce, x, backend="cuda_fused")
    R.assert_staging_free(R.reduce, x, backend="cuda_hier")
    R.assert_staging_free(R.reduce, x, kind="sumsq", backend="cuda_fused")
    leaves = _leaves(dtype)
    floor = min(t.numel() for t in leaves)
    R.assert_staging_free(R.reduce_many, leaves, backend="cuda_fused", min_elems=floor)
    R.assert_staging_free(R.reduce_tree, leaves, kind="norm2", backend="cuda_fused",
                          min_elems=floor)


def test_staging_audit_fails_on_a_host_cast():
    x = _x(torch.bfloat16)
    found = R.staging_ops(lambda a: a.float().sum(), x)
    assert found == [("_to_copy", N, 4 * N)]
    with pytest.raises(AssertionError, match="zero-copy contract violated"):
        R.assert_staging_free(lambda a: a.float().sum(), x)
    # the non-kernel route packs the arrays: a concatenation the audit sees
    leaves = _leaves()
    found = R.staging_ops(R.reduce_many, leaves, backend="mma_torch",
                          min_elems=sum(t.numel() for t in leaves))
    assert "cat" in [f[0] for f in found]
    # a prologue pass on the host, flagged with extra=PROLOGUE_OPS
    with pytest.raises(AssertionError):
        R.assert_staging_free(lambda a: R.reduce(a * a, backend="cuda_fused"), _x(),
                              extra=("mul",))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_measured_bytes_equal_the_plan_model(dtype):
    x = _x(dtype)
    n = x.numel()
    hier = R.plan_for(x.shape, dtype, backend="cuda_hier")
    assert R.measured_hbm_bytes(R.reduce, x, plan=hier) == hier.hbm_bytes(n, dtype).launch_io
    moments = hier.hbm_bytes(n, dtype, prologue="moments").launch_io
    assert R.measured_hbm_bytes(R.reduce, x, kind="moments", plan=hier) == moments
    # the fused kernel's one-lane in-launch finish
    one = R.plan_for(x.shape, dtype, backend="cuda_fused", num_lanes=1)
    assert R.measured_hbm_bytes(R.reduce, x, plan=one, epilogue="sqrt") == \
        one.hbm_bytes(n, dtype, epilogue=1).launch_io
    # the parts kernel: every part in once, the (S [+ K] [+ S + 1]) row out
    leaves = _leaves(dtype)
    total = sum(t.numel() for t in leaves)
    parts = R.plan_for((total,), dtype, backend="cuda_fused")
    assert R.measured_hbm_bytes(R.reduce_many, leaves, plan=parts) == \
        parts.hbm_bytes(total, dtype, segments=4).launch_io
    fork = [(), ("clip_coeff", 1.0, 1e-9)]
    tree = R.plan_for((total,), torch.float32, kind="sumsq", backend="cuda_fused")
    got = R.measured_hbm_bytes(R.reduce_tree, leaves, kind="norm2", plan=tree, epilogue=fork,
                               census=True)
    assert got == tree.hbm_bytes(total, dtype, segments=4, epilogue=2, census=True).launch_io


def test_measured_bytes_of_the_fused_lanes():
    x = _x()
    for lanes in (2, 5):
        plan = R.plan_for(x.shape, x.dtype, backend="cuda_fused", num_lanes=lanes,
                          tiles_per_block=1)
        want = C.fused_launch_bytes(x.numel(), 4, num_lanes=lanes, tiles_per_block=1)
        assert R.measured_hbm_bytes(R.reduce, x, plan=plan) == want.launch_io
        # the read side is the model's
        assert want.kernel_read - 2 * lanes * 4 == plan.hbm_bytes(x.numel(), x.dtype).kernel_read


def test_measured_bytes_charge_staging_copies():
    x = _x(torch.bfloat16)
    plan = R.plan_for(x.shape, torch.float32, backend="cuda_fused", num_lanes=1)
    staged = R.measured_hbm_bytes(lambda a: R.reduce(a.float(), plan=plan, epilogue="sqrt"), x)
    assert staged == 4 * N + (4 * N + 4)  # the f32 copy, then the launch over it


def test_epilogue_and_census_audits_on_the_clip_statistic():
    leaves = _leaves()
    R.assert_epilogue_free(optim.global_norm_and_clip, leaves, 1.0, backend="cuda_fused")
    R.assert_census_free(optim.global_norm_and_clip, leaves, 1.0, backend="cuda_fused",
                         census=True)
    # the host route finishes on the host: sqrt, min and the NaN sweep show
    found = {op for op, _ in R.epilogue_ops(optim.global_norm_and_clip, leaves, 1.0,
                                            backend="torch")}
    assert "sqrt" in found
    assert R.census_ops(optim.global_norm_and_clip, leaves, 1.0, backend="torch", census=True)


def test_launches_on_another_thread_are_metered():
    # a backward pass on a CUDA device runs on autograd's own thread, and a
    # remat recompute launches kernels there: the meter is process-wide
    import threading

    x = _x()

    def on_a_thread():
        t = threading.Thread(target=lambda: R.reduce(x, backend="cuda_fused"))
        t.start()
        t.join()
        return R.reduce(x, backend="cuda_fused")

    _, counts = R.count_kernel_launches(on_a_thread, include_plain=True)
    assert _only(counts) == {"mma_sum_fused": 2}


def test_meter_counts_every_launch_of_many_threads():
    # the record lists are shared by every thread under a lock: a lost
    # update would drop a count
    import sys
    import threading

    x = _x(n=2 * 128 * 128)
    threads, calls = 16, 5

    def work():
        for _ in range(calls):
            R.reduce(x, backend="cuda_fused")

    def many():
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, counts = R.count_kernel_launches(many, include_plain=True)
    finally:
        sys.setswitchinterval(interval)
    assert _only(counts) == {"mma_sum_fused": threads * calls}


@pytest.mark.parametrize("lanes,kahan,outputs", [(1, False, 1), (1, False, 2), (5, False, 1),
                                                 (5, False, 2), (1, True, 1), (5, True, 1)])
def test_plain_note_is_the_launch_note(lanes, kahan, outputs):
    # the card notes the bytes of the tensors a fused launch was given
    # (``_fused_io``); the CPU's note for the plain version stands in for
    # the same tensors, built here as ``_launch_fused`` / ``_launch_kahan``
    # build them
    from repro_torch.kernels.mma_reduce import ops

    flat = _x(torch.bfloat16)
    c = ops.lane_geometry(flat.numel(), lanes, 1)[1]
    lane_words = (torch.empty((c, 2), dtype=torch.float32) if kahan
                  else ops._lane_scratch(c, flat.device))
    out = torch.empty((outputs,), dtype=torch.float32)
    assert ops._fused_io(flat, out, lane_words) == ops._fused_plain_io(
        flat, lanes, 1, outputs, kahan=kahan)
    want = C.fused_launch_bytes(flat.numel(), 2, num_lanes=lanes, tiles_per_block=1,
                                outputs=outputs, kahan=kahan)
    assert ops._fused_io(flat, out, lane_words) == (want.kernel_read, want.kernel_write)
