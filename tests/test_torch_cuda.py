"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: these need an NVIDIA GPU and nvcc, and skip elsewhere
(the decision is taken inside the fixture, never at import). Run them on
the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: one bf16 ulp for the norms (same
roundings, other f32 summation orders), 2 bf16 ulps + 2e-3 for attention,
1e-6 x mass for the parts sums and exact census counts; for the fused
full reduction the same compute-dtype roundings of every element are
summed in f32 in other orders: one f32 ulp of the running sum per
accumulation step, n / (lanes x 256) steps per thread (tensor cores may
truncate their f32 accumulation, so the error can be one-sided), times
the mass, with exact counts and bitwise repeats;
for the cross-entropy 1e-3 (the same tiles and running max, but expf and
torch.exp may differ in the last ulp and flip one bf16 rounding of p).
"""

import pytest
import torch

from repro_torch.kernels import (
    common,
    cross_entropy,
    flash_attention,
    layernorm_np,
    mma_sum_fused,
    mma_sum_parts,
    rmsnorm,
)
from repro_torch.kernels.cross_entropy import cross_entropy_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.mma_reduce import lane_geometry, mma_sum_fused_plain, mma_sum_parts_plain
from repro_torch.kernels.row_moments import layernorm_np_plain, rmsnorm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _ulp_close(got, want, ulps=1):
    g, w = got.float(), want.float()
    return bool(torch.all((g - w).abs() <= ulps * 2.0**-7 * w.abs() + 1e-6))


@pytest.mark.parametrize("rows,d", [(1, 16), (37, 64), (300, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_norms_match_plain(gen, rows, d, dtype):
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 1).to(dtype)
    gamma = torch.rand((d,), generator=gen, device="cuda") + 0.5
    before = layernorm_np.launches
    assert _ulp_close(layernorm_np(x), layernorm_np_plain(x))
    assert _ulp_close(rmsnorm(x, gamma), rmsnorm_plain(x, gamma))
    assert layernorm_np.launches == before + 1


@pytest.mark.parametrize("case", [
    (2, 4, 4, 100, 100, 32, True, None, 0),
    (1, 8, 2, 130, 200, 64, False, None, 0),
    (1, 4, 2, 200, 200, 128, True, 64, 0),
    (1, 2, 1, 40, 200, 16, True, None, 160),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(gen, case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, q_offset = case
    q, k, v = ((torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, plain = flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype
    diff = (out.float() - plain.float()).abs()
    assert bool(torch.all(diff <= 2.0**-6 * plain.float().abs() + 2e-3))


def test_flash_attention_rejects_unsupported_head_dim(gen):
    q = torch.zeros((1, 1, 8, 24), device="cuda")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def test_parts_match_plain_with_census(gen):
    sizes = (100, 0, 20000, 16384, 3 * 16384 + 5)
    parts = [torch.randn((n,), generator=gen, device="cuda") for n in sizes]
    parts[2][7] = float("nan")
    parts[4][-1] = float("inf")
    parts.append(torch.randn((50,), generator=gen, device="cuda").to(torch.bfloat16))
    chains = ((), (("clip_coeff", 1.0),), (("sqrt",), ("scale", 0.5)))
    out = mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)
    plain = mma_sum_parts_plain(parts, ("square",) * len(parts), chains, True)
    s = len(parts)
    assert torch.equal(out[s + len(chains):], plain[s + len(chains):])
    assert out[s + len(chains):].tolist() == [0, 0, 1, 0, 1, 0, 2]
    mass = float(sum(torch.nan_to_num(p.float(), posinf=0.0).square().sum() for p in parts))
    fin = torch.isfinite(plain)
    assert torch.equal(fin, torch.isfinite(out))
    assert float((out[fin] - plain[fin]).abs().max()) <= 1e-6 * mass


def test_parts_repeat_launches_agree(gen):
    # the fold ticket resets itself: later launches, of other tile counts
    # too, fold exactly as the first one did
    parts = [torch.randn((n,), generator=gen, device="cuda") for n in (50304, 7, 40000)]
    first = mma_sum_parts(parts, prologue="square", total_chains=((),), census=True)
    for n_parts in (1, 3, 2, 3):
        again = mma_sum_parts(parts[:n_parts], prologue="square", total_chains=((),),
                              census=True)
        if n_parts == 3:
            assert torch.equal(again, first)
        else:
            plain = mma_sum_parts_plain(parts[:n_parts], ("square",) * n_parts, ((),), True)
            assert torch.equal(again[-n_parts - 1:], plain[-n_parts - 1:])


def test_mixed_devices_raise(gen):
    with pytest.raises(ValueError):
        rmsnorm(torch.ones((2, 16), device="cuda"), torch.ones(16))
    assert "mma_sum_parts" in common.KERNEL_WRAPPERS


@pytest.mark.parametrize("rows,width,vocab", [(2048, 50432, 50304), (37, 1000, 1000),
                                              (20, 2305, 2301)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_matches_plain(gen, rows, width, vocab, dtype):
    logits = (torch.randn((rows, width), generator=gen, device="cuda") * 3).to(dtype)
    logits[:, vocab:] = -1e30
    labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda")
    before = cross_entropy.launches
    out = cross_entropy(logits, labels)
    plain = cross_entropy_plain(logits, labels)
    assert cross_entropy.launches == before + 1
    assert float((out - plain).abs().max()) <= 1e-3
    # the cut width (odd for 2301: unpaired loads) gives the padded loss
    cut = cross_entropy(logits[:, :vocab].contiguous(), labels)
    assert float((cut - out).abs().max()) <= 1e-6


def test_cross_entropy_grad_on_card(gen):
    logits = (torch.randn((64, 700), generator=gen, device="cuda") * 2).requires_grad_(True)
    labels = torch.randint(0, 700, (64,), generator=gen, device="cuda")
    (got,) = torch.autograd.grad(cross_entropy(logits, labels).sum(), logits)
    want = torch.softmax(logits.detach(), -1)
    want[torch.arange(64), labels] -= 1.0
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 2048, 3 * 16384 + 5, 40 * 131072 + 17])
@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("dtype,compute", [(torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float32),
                                           (torch.float16, torch.float16)])
@pytest.mark.parametrize("prologue", ["identity", "square", "abs"])
def test_fused_sum_matches_plain(gen, n, lanes, dtype, compute, prologue):
    x = (torch.randn((n,), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    kw = dict(compute_dtype=compute, prologue=prologue, num_lanes=lanes)
    got = mma_sum_fused(x, **kw)
    want = mma_sum_fused_plain(x, **kw)
    xf = x.float()
    mass = float((xf * xf if prologue == "square" else xf.abs()).sum())
    c = lane_geometry(n, lanes)[1]
    assert abs(float(got) - float(want)) <= max(1.0, n / (c * 256)) * 2.0**-23 * mass + 1e-6
    assert torch.equal(got, mma_sum_fused(x, **kw))  # repeat launches agree bitwise


def test_fused_census_and_epilogue(gen):
    x = torch.randn((5 * 131072 + 3,), generator=gen, device="cuda")
    x[[7, 131072, x.numel() - 1]] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                                 device="cuda")
    tot, cnt = mma_sum_fused(x, census=True, num_lanes=4)
    assert float(cnt) == 3.0 and not torch.isfinite(tot)
    clean = x.nan_to_num(0.0, 0.0, 0.0)
    chain = (("sqrt",), ("clip_coeff", 1.0, 1e-9))
    got, cnt = mma_sum_fused(clean, prologue="square", epilogue=chain, census=True,
                             compute_dtype=torch.float32, num_lanes=4)
    want = mma_sum_fused_plain(clean, torch.float32, "square", chain, False, 4)
    assert float(cnt) == 0.0 and abs(float(got) - float(want)) <= 1e-6 * float(want)


# ------------------- the paper's reduction engine: K10, K2, K3 -------------------

_UNIT = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _tile_tol(x, compute, prologue):
    """Per tile of a K10 level: two ulps of the tile's largest row sum at
    the compute dtype (a row sum summed in another order may round the
    other way before the second MMA), plus f32 noise of the tile's mass."""
    from repro_torch.kernels.mma_reduce.ops import TILE, _map, _round

    t = -(-x.numel() // TILE)
    v = _map(_round(x.float(), compute), "square" if prologue == "moments" else prologue, compute)
    rows = torch.nn.functional.pad(v, (0, t * TILE - v.numel())).view(t, 128, 128).sum(-1)
    return 2 * _UNIT[compute] * rows.abs().amax(-1) + 2.0**-16 * rows.abs().sum(-1) + 1e-6


@pytest.mark.parametrize("n", [1, 5000, 3 * 16384 + 5, 40 * 16384 + 17])
@pytest.mark.parametrize("dtype,compute", [(torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float32),
                                           (torch.float16, torch.float16)])
@pytest.mark.parametrize("prologue", ["identity", "square", "abs", "moments"])
def test_tile_partials_match_plain(gen, n, dtype, compute, prologue):
    from repro_torch.kernels.mma_reduce import tile_partials, tile_partials_plain

    x = (torch.randn((n,), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    before = tile_partials.launches
    got = tile_partials(x, compute_dtype=compute, prologue=prologue)
    assert tile_partials.launches == before + 1
    want = tile_partials_plain(x, compute, prologue)[:got.shape[0]]
    tol = _tile_tol(x, compute, prologue)
    diff = (got - want).abs()
    if prologue == "moments":
        assert bool(torch.all(diff[:, 1] <= tol))
        assert bool(torch.all(diff[:, 0] <= _tile_tol(x, compute, "abs")))
    else:
        assert bool(torch.all(diff <= tol))


@pytest.mark.parametrize("n", [2**20, 2**24 - 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hierarchy_launches_and_bytes_match_cost_model(gen, n, dtype):
    from repro_torch.core import cost_model
    from repro_torch.kernels.mma_reduce import mma_sum_hier, tile_partials

    x = torch.randn((n,), generator=gen, device="cuda").to(dtype)
    before, tr = tile_partials.launches, []
    total = mma_sum_hier(x, trace=tr)
    model = cost_model.hier_hbm_bytes(n, x.element_size())
    assert tile_partials.launches - before == cost_model.levels(n, 128) == tr[0].levels
    assert tr[0].launch_io_bytes == model.launch_io and tr[0].hbm_bytes == model.total
    plain = mma_sum_hier(x.cpu())
    mass = float(x.float().abs().sum())
    assert abs(float(total) - float(plain)) <= 2 * 2.0**-7 * mass / 128 + 1e-3


@pytest.mark.parametrize("n", [1, 3 * 16384 + 5, 40 * 131072 + 17])
@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("dtype,compute", [(torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float32)])
def test_moments_and_kahan_match_plain(gen, n, lanes, dtype, compute):
    from repro_torch.kernels.mma_reduce import (mma_moments_fused, mma_moments_fused_plain,
                                                mma_sum_kahan, mma_sum_kahan_plain)

    x = (torch.randn((n,), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    s, ss = mma_moments_fused(x, compute_dtype=compute, num_lanes=lanes)
    ps, pss = mma_moments_fused_plain(x, compute, lanes)
    xf = x.float()
    c = lane_geometry(n, lanes)[1]
    steps = max(1.0, n / (c * 256)) * 2.0**-23
    assert abs(float(s) - float(ps)) <= steps * float(xf.abs().sum()) + 1e-6
    assert abs(float(ss) - float(pss)) <= steps * float((xf * xf).sum()) + 1e-6
    again = mma_moments_fused(x, compute_dtype=compute, num_lanes=lanes)
    assert torch.equal(s, again[0]) and torch.equal(ss, again[1])
    k = mma_sum_kahan(x, compute_dtype=compute, num_lanes=lanes)
    kp = mma_sum_kahan_plain(x, compute, "identity", (), lanes)
    # the same row sums up to their summation order, carried and folded
    # by the same compensated steps
    assert abs(float(k) - float(kp)) <= 2.0**-20 * float(xf.abs().sum()) + 1e-6
    assert torch.equal(k, mma_sum_kahan(x, compute_dtype=compute, num_lanes=lanes))


def test_kahan_beats_native_where_the_carry_dominates(gen):
    from repro_torch.core.precision import ulps

    # one lane, 1024 tiles: mean 1 + 5e-4, one-sided noise of width 1e-3
    x = 1.0 + torch.rand((2**24,), generator=gen, device="cuda") * 1e-3
    exact = float(x.double().sum())
    native = float(mma_sum_fused(x, compute_dtype=torch.float32, num_lanes=1))
    kahan = float(mma_sum_fused(x, compute_dtype=torch.float32, num_lanes=1, kahan=True))
    assert ulps(native, exact) >= 10
    assert abs(kahan - exact) <= abs(native - exact)


@pytest.mark.parametrize("backend", ["torch", "mma_torch", "cuda_hier", "cuda_fused"])
@pytest.mark.parametrize("kind", ["sum", "mean", "sumsq", "norm2", "moments"])
@pytest.mark.parametrize("precision", ["native", "kahan"])
def test_reduce_card_matches_cpu(gen, backend, kind, precision):
    from repro_torch import reduce as R

    x = torch.randn((2**16 + 5,), generator=gen, device="cuda") * 2 + 0.3
    got = R.reduce(x, kind=kind, backend=backend, precision=precision, num_lanes=4)
    want = R.reduce(x.cpu(), kind=kind, backend=backend, precision=precision, num_lanes=4)
    pairs = zip(got, want) if kind == "moments" else [(got, want)]
    for g, w in pairs:
        assert g.device.type == "cuda"
        assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w)) + 1e-3


# ------------------- the multi-reduce and scan kernels (K8, K9, K4) -------------------

SEG_OFFSETS = (0, 0, 100, 20000, 20000, 3 * 16384 + 5, 3 * 16384 + 7, 9 * 16384 - 3)


@pytest.mark.parametrize("lanes", [1, 3, 528])
@pytest.mark.parametrize("dtype,compute", [(torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("prologue", ["identity", "square", "moments"])
def test_segments_match_plain(gen, lanes, dtype, compute, prologue):
    from repro_torch.kernels.mma_reduce import ops

    x = (torch.randn((SEG_OFFSETS[-1],), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    before = ops.mma_sum_segments.launches
    got = ops.mma_sum_segments(x, SEG_OFFSETS, compute_dtype=compute, prologue=prologue,
                               num_lanes=lanes)
    assert ops.mma_sum_segments.launches == before + 1
    want = ops.mma_sum_segments_plain(x, SEG_OFFSETS, compute, prologue, (), False, lanes)
    if compute == torch.float32:  # CUDA-core adds in the plain version's order
        assert torch.equal(got, want)
    else:  # tensor-core f32 sums of the same products in another order
        xf = x.float()
        assert float((got - want).abs().max()) <= 2.0**-16 * float((xf * xf).sum()) + 1e-4


def test_segments_census_and_empty_epilogue(gen):
    from repro_torch.kernels.mma_reduce import ops

    x = torch.randn((SEG_OFFSETS[-1],), generator=gen, device="cuda")
    x[[150, 3 * 16384 + 6]] = torch.tensor([float("nan"), float("inf")], device="cuda")
    chain = (("add_eps", 2.0),)
    outs = [ops.mma_sum_segments(x, SEG_OFFSETS, census=True, epilogue=chain, num_lanes=c)
            for c in (1, 2, 7)]
    plain = ops.mma_sum_segments_plain(x, SEG_OFFSETS, torch.bfloat16, "identity", chain, True)
    n = len(SEG_OFFSETS) - 1
    for out in outs:
        assert torch.equal(out[n:], plain[n:]) and float(out[n:].sum()) == 2.0
        assert float(out[0]) == float(out[3]) == 2.0  # empty segments: the chain of 0


@pytest.mark.parametrize("n", [1, 5000, 3 * 16384 + 5, 2**22 + 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_matches_plain_and_is_lane_invariant(gen, n, dtype, inclusive):
    from repro_torch.kernels.scan import ops as sops

    x = (torch.randn((n,), generator=gen, device="cuda") + 0.1).to(dtype)
    outs = [sops.mma_scan(x, inclusive=inclusive, num_lanes=c, tiles_per_block=1)
            for c in (1, 2, 4, 8)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    want = sops.mma_scan_plain(x, inclusive)[:n]
    if dtype == torch.float32:
        assert torch.equal(outs[0], want)
    else:  # one ulp of the storage dtype, plus f32 order noise of the running mass
        # (equal values pass: past 65504 the f16 prefix is inf on both sides)
        run = torch.cumsum(x.double().abs(), 0)
        g, w = outs[0].double(), want.double()
        assert bool(torch.all(((g - w).abs() <= 2.0**-7 * w.abs() + 2.0**-17 * run + 1e-5)
                              | (g == w)))
    if not inclusive:
        inc = sops.mma_scan(x)
        assert float(outs[0][0]) == 0.0 and torch.equal(outs[0][1:], inc[:-1])


@pytest.mark.parametrize("n", [1, 128 * 128, 128 * 128 + 1, 3 * 2**20 + 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("inclusive", [True, False])
def test_lookback_scan_bitwise_across_lanes_and_launches(gen, n, dtype, inclusive):
    # f32: bitwise the plain version (the same adds in the same order);
    # bf16 / f16: the tolerance of the cell above (tensor-core f32 sums in
    # their own order). Bitwise across lane counts and five launches in
    # every dtype: the look-back keeps the left-to-right carry chain.
    from repro_torch.core import cost_model
    from repro_torch.kernels.scan import ops as sops

    x = (torch.randn((n + 1,), generator=gen, device="cuda") + 0.1).to(dtype)
    for xin in (x[:n], x[1:]):  # 16-byte aligned, and not (the element-wise loads)
        before, tr = sops.mma_scan.launches, []
        first = sops.mma_scan(xin, inclusive=inclusive, trace=tr)
        assert sops.mma_scan.launches == before + 1
        assert tr[0].launch_io_bytes == \
            cost_model.lookback_scan_hbm_bytes(n, xin.element_size()).launch_io
        for lanes in (1, 2, 8):
            assert torch.equal(sops.mma_scan(xin, inclusive=inclusive, num_lanes=lanes,
                                             tiles_per_block=1), first)
        for _ in range(5):
            assert torch.equal(sops.mma_scan(xin, inclusive=inclusive), first)
        want = sops.mma_scan_plain(xin, inclusive)[:n]
        if dtype == torch.float32:
            assert torch.equal(first, want)
        else:
            run = torch.cumsum(xin.double().abs(), 0)
            g, w = first.double(), want.double()
            assert bool(torch.all(((g - w).abs() <= 2.0**-7 * w.abs() + 2.0**-17 * run + 1e-5)
                                  | (g == w)))


def test_auto_reduce_reaches_the_fused_kernel(gen):
    from repro_torch import reduce as R

    x = torch.randn((2 * 128 * 128,), generator=gen, device="cuda")
    assert R.plan_for(x.shape, x.dtype, device=x.device).backend == "cuda_fused"
    before = mma_sum_fused.launches
    got = R.reduce(x)
    assert mma_sum_fused.launches == before + 1
    assert abs(float(got) - float(R.reduce(x.cpu()))) <= 2.0**-7 * float(x.abs().sum()) / 64
    before = mma_sum_parts.launches
    R.reduce_tree([x, x[:7]], kind="sumsq")
    assert mma_sum_parts.launches == before + 1
    # f64 (which the kernels cannot read) stays on mma_torch and runs
    x64 = x.double()
    assert R.plan_for(x64.shape, x64.dtype, device=x64.device).backend == "mma_torch"
    before = mma_sum_fused.launches
    got64 = R.reduce(x64)
    assert mma_sum_fused.launches == before
    assert got64.dtype == torch.float64
    assert abs(float(got64) - float(x64.sum())) <= x64.numel() * 2.0**-53 * float(x64.abs().sum())
    many = R.reduce_many([x64, x64[:7]])
    torch.testing.assert_close(many, torch.stack([x64.sum(), x64[:7].sum()]),
                               rtol=0, atol=x64.numel() * 2.0**-53 * float(x64.abs().sum()))


@pytest.mark.parametrize("case", [  # chip_smoke.py's check_attention cases
    (4, 16, 16, 512, 512, 128, True, None, 0),
    (4, 16, 16, 256, 256, 128, True, None, 0),
    (1, 16, 4, 64, 320, 128, True, 128, 256),
    (2, 4, 2, 100, 100, 64, False, None, 0),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_attention_main_path_cases_match_plain(gen, case, dtype):
    # tolerance: 2 bf16 ulps of the output + 2e-3 (the same 128-key blocks,
    # f32 sums in another order, which can flip one bf16 rounding of p)
    b, hq, hkv, sq, skv, d, causal, window, q_offset = case
    q, k, v = ((torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert bool(torch.all((out.float() - plain.float()).abs()
                          <= 2.0**-6 * plain.float().abs() + 2e-3))
    assert torch.equal(flash_attention(q, k, v, **kw), out)


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float16])
def test_parts_bf16_compute_moments_and_slot_chain_match_plain(gen, compute):
    from repro_torch.kernels.mma_reduce import ops

    parts = [torch.randn(s, generator=gen, device="cuda") for s in (100, 0, 20000, 70000)]
    parts[2] = parts[2].to(torch.bfloat16)
    for pros, chain in (("identity", ()), (("moments", "identity", "square", "moments"), ()),
                        ("square", (("sqrt",),))):
        got = ops.mma_sum_parts(parts, compute_dtype=compute, prologue=pros, slot_epilogue=chain)
        names = (pros,) * 4 if isinstance(pros, str) else pros
        want = ops.mma_sum_parts_plain(parts, names, (), False, compute, chain)
        mass = sum(float((p.float() ** 2).sum() + p.float().abs().sum()) for p in parts)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2.0**-16 * mass + 1e-4
        assert torch.equal(got, ops.mma_sum_parts(parts, compute_dtype=compute, prologue=pros,
                                                  slot_epilogue=chain))


# ------------------- the fused matmul with its row moments (K11) -------------------


def _matmul_stats_close(x, w, got, want):
    """Y within one ulp of its dtype (a sum near a rounding boundary may
    round the other way) plus two f32 ulps of the product's absolute mass
    per accumulation step of 16 (the tensor cores' f32 accumulation may
    truncate; the plain version sums in another order);
    s and ss within 1e-5 of each row's sum of |y| and of y^2 (both are sums
    of the f32 accumulator, not of the stored Y)."""
    from repro_torch.kernels.common import bf16_round

    (y, s, ss), (yp, sp, ssp) = got, want
    k = x.shape[1]
    mass = bf16_round(x.float()).abs() @ bf16_round(w.float()).abs()
    ulp = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}[y.dtype]
    ok_y = torch.all((y.float() - yp.float()).abs()
                     <= ulp * yp.float().abs() + 2.0**-22 * -(-k // 16) * mass + 1e-6)
    y32 = bf16_round(x.float()) @ bf16_round(w.float())
    ok_s = torch.all((s - sp).abs() <= 1e-5 * y32.abs().sum(-1) + 1e-5)
    ok_ss = torch.all((ss - ssp).abs() <= 1e-5 * (y32 * y32).sum(-1) + 1e-5)
    return bool(ok_y), bool(ok_s), bool(ok_ss)


# (m, k, n): ragged, tiny, 16-byte-unaligned K and N at 16-bit widths, and aligned
MS_SHAPES = [(1, 2, 2), (33, 65, 129), (100, 300, 500), (128, 256, 256), (300, 1024, 384),
             (257, 100, 260)]


@pytest.mark.parametrize("m,k,n", MS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_matmul_stats_matches_plain_one_launch_bitwise_repeat(gen, m, k, n, dtype):
    from repro_torch.kernels import matmul_stats
    from repro_torch.kernels.matmul_stats import matmul_stats_plain

    x = (torch.randn((m, k), generator=gen, device="cuda") + 0.1).to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.5).to(dtype)
    before = matmul_stats.launches
    got = matmul_stats(x, w)
    assert matmul_stats.launches == before + 1
    again = matmul_stats(x, w)
    want = matmul_stats_plain(x, w)
    assert got[0].dtype == dtype and got[0].shape == (m, n)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _matmul_stats_close(x, w, got, want) == (True, True, True)


@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.bfloat16),
                                     (torch.float16, torch.float32)])
def test_matmul_stats_mixed_dtypes_and_unaligned_views(gen, xdt, wdt):
    from repro_torch.kernels import matmul_stats
    from repro_torch.kernels.matmul_stats import matmul_stats_plain

    base = torch.randn((70, 131), generator=gen, device="cuda").to(xdt)
    x = base[:, 1:]  # not 16-byte aligned, not contiguous: the wrapper's copy
    w = torch.randn((130, 96), generator=gen, device="cuda").to(wdt)
    got = matmul_stats(x, w)
    assert got[0].dtype == xdt
    assert _matmul_stats_close(x, w, got, matmul_stats_plain(x, w)) == (True, True, True)
    x_off = torch.randn((70 * 130 + 1,), generator=gen, device="cuda").to(xdt)[1:].view(70, 130)
    got = matmul_stats(x_off, w)  # contiguous at an odd element offset: the scalar loads
    assert _matmul_stats_close(x_off, w, got, matmul_stats_plain(x_off, w)) == (True, True, True)


def test_matmul_stats_card_matches_cpu(gen):
    from repro_torch.kernels import matmul_stats

    x = torch.randn((100, 500), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((500, 300), generator=gen, device="cuda").to(torch.bfloat16)
    got = matmul_stats(x, w)
    cpu = matmul_stats(x.cpu(), w.cpu())
    assert _matmul_stats_close(x, w, got, [t.cuda() for t in cpu]) == (True, True, True)
