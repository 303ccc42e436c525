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
from repro_torch.kernels import common, mma_reduce
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


def test_parts_bf16_compute_works_and_f64_compute_raises():
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


# ---------------- K4's cross-CTA fold, emulated in random orders ----------------


def _fold_emulation(parts, pros, total_chains, census, slot_chain, rng, tickets, chunk=1024):
    """A CPU model of ``csrc/parts_reduce.cu``'s fold, fed the tile
    partials in ``parts`` (per part ``None`` when empty, else (sums,
    squares, counts) per tile). CTAs finish in a random order; each
    publishes its partials into scratch that starts as NaN (a word read
    before it is published would poison the row) and takes its part's
    ticket. The part's last CTA folds the part in staged chunks, in tile
    order, at a random later point among the other CTAs' events; it
    publishes the part total and takes the grid ticket, and the last of
    those writes the row, parts in order. ``tickets`` (PARTS_KERNEL_MAX + 1
    ints) persists across calls, as the kernel's buffer does."""
    max_parts = mma_reduce.PARTS_KERNEL_MAX
    live = [s for s, p in enumerate(parts) if p is not None]
    starts = np.cumsum([0] + [len(parts[s][0]) for s in live])
    n_tiles = int(starts[-1])
    nseg, dual = len(parts), "moments" in pros
    tile_sum = np.full(n_tiles, np.nan, np.float32)
    tile_sq = np.full(n_tiles, np.nan, np.float32)
    tile_cnt = np.full(n_tiles, -(2**40), np.int64)
    part_tot = {}
    row = {}
    events = [("tile", t) for t in rng.permutation(n_tiles)]
    pending = []

    def fold_part(i):
        ps, ps2, pc = np.float32(0), np.float32(0), 0
        for c0 in range(starts[i], starts[i + 1], chunk):
            c1 = min(c0 + chunk, starts[i + 1])
            st = tile_sum[c0:c1].copy(), tile_sq[c0:c1].copy(), tile_cnt[c0:c1].copy()
            for a, b, c in zip(*st):
                ps, ps2, pc = np.float32(ps + a), np.float32(ps2 + b), pc + int(c)
        part_tot[i] = (ps, ps2, pc)
        grid = tickets[max_parts]
        tickets[max_parts] += 1
        if grid == len(live) - 1:
            tickets[max_parts] = 0
            row["out"] = write_row()

    def write_row():
        out_slots = 2 * nseg if dual else nseg
        out = np.zeros(out_slots + len(total_chains) + ((nseg + 1) if census else 0), np.float32)
        total, total_cnt = np.float32(0), 0
        for i, s in enumerate(live):
            ps, ps2, pc = part_tot[i]
            out[s] = common.apply_epilogue(torch.tensor(ps), slot_chain).numpy()
            if pros[s] == "moments":
                out[nseg + s] = ps2
            total = np.float32(total + ps)
            if census:
                out[out_slots + len(total_chains) + s] = pc
                total_cnt += pc
        for k, ch in enumerate(total_chains):
            out[out_slots + k] = common.apply_epilogue(torch.tensor(total), ch).numpy()
        if census:
            out[-1] = total_cnt
        return out

    while events or pending:
        if pending and (not events or rng.random() < 0.3):
            fold_part(pending.pop(rng.integers(len(pending))))
            continue
        _, t = events.pop()
        i = int(np.searchsorted(starts, t, side="right") - 1)
        sums, squares, counts = parts[live[i]]
        j = t - starts[i]
        tile_sum[t], tile_sq[t], tile_cnt[t] = sums[j], squares[j], counts[j]
        mine = tickets[i]
        tickets[i] += 1
        if mine == starts[i + 1] - starts[i] - 1:
            tickets[i] = 0
            pending.append(i)
    return row["out"]


def _seeded_partials(tiles, rng, moments):
    return [None if n == 0 else (
        (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32),
        (rng.random(n) * 100).astype(np.float32) if m else np.zeros(n, np.float32),
        rng.integers(0, 3, n)) for n, m in zip(tiles, moments)]


def _plain_fold(monkeypatch, partials, pros, total_chains, census, slot_chain):
    """``mma_sum_parts_plain``'s fold of the same tile partials: its per-tile
    pass (``_part_tile_sums``) replaced by the seeded partials."""
    from repro_torch.kernels.mma_reduce import ops

    feed = iter([p for p in partials if p is not None])

    def seeded(flat, pro, compute_dtype):
        sums, squares, counts = next(feed)
        return (torch.from_numpy(sums), torch.from_numpy(squares) if pro == "moments" else None,
                int(counts.sum()))

    monkeypatch.setattr(ops, "_part_tile_sums", seeded)
    dummies = [torch.zeros(0 if p is None else 1) for p in partials]
    return ops.mma_sum_parts_plain(dummies, pros, total_chains, census, torch.bfloat16,
                                   slot_chain).numpy()


FOLD_CASES = {
    # tiles per part: one-tile parts, empty parts between live ones, a part
    # wider than one staged chunk, and exactly PARTS_KERNEL_MAX live parts
    "one-tile-and-empty": ((1, 0, 3, 0, 0, 1, 2500, 1), False),
    "max-parts": (tuple(int(n) for n in np.random.default_rng(7).integers(1, 5, 128)), False),
    "moments": ((2, 0, 1100, 1, 5), True),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_parts_fold_is_the_plain_fold_in_any_finishing_order(monkeypatch, case):
    tiles, moments = FOLD_CASES[case]
    rng = np.random.default_rng(len(tiles))
    if moments:
        pros = tuple("moments" if i % 2 == 0 else "identity" for i in range(len(tiles)))
        total_chains, census, slot_chain = (), False, ()
    else:
        pros = tuple(("square", "identity", "abs")[i % 3] for i in range(len(tiles)))
        total_chains = ((("sqrt",),), (("sqrt",), ("clip_coeff", 1.0, 1e-9)))
        census, slot_chain = True, (("scale", 0.5),)
    partials = _seeded_partials(tiles, rng, [moments and p == "moments" for p in pros])
    want = _plain_fold(monkeypatch, partials, pros, total_chains, census, slot_chain)
    tickets = [0] * (mma_reduce.PARTS_KERNEL_MAX + 1)
    for _ in range(6):
        got = _fold_emulation(partials, pros, total_chains, census, slot_chain, rng, tickets)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert not any(tickets)  # every last CTA reset its counter


def test_parts_fold_tickets_reset_across_launches_of_other_part_counts(monkeypatch):
    # back-to-back launches with different live part counts share one ticket
    # buffer; each finds it zeroed and folds as the plain version does
    rng = np.random.default_rng(11)
    tickets = [0] * (mma_reduce.PARTS_KERNEL_MAX + 1)
    for tiles in ((3, 1, 2), (1,), (0, 4, 0, 2, 1, 1), (2, 2)):
        pros = ("square",) * len(tiles)
        partials = _seeded_partials(tiles, rng, [False] * len(tiles))
        want = _plain_fold(monkeypatch, partials, pros, ((),), True, ())
        got = _fold_emulation(partials, pros, ((),), True, (), rng, tickets)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert not any(tickets)


def test_parts_scratch_words_hold_the_kernels_layout():
    # tile sums, squares and counts, then from an even word the part sums
    # and squares (f32) and 8-byte-aligned part counts (int64)
    for n_tiles in (1, 2, 3, 71840):
        words = mma_reduce.parts_scratch_words(n_tiles)
        part_base = (3 * n_tiles + 1) // 2 * 2
        assert part_base % 2 == 0 and part_base >= 3 * n_tiles
        assert words == part_base + 2 * 128 + 2 * 128
