"""Port parity: ``repro_torch.kernels.cross_entropy`` (K7) against the
reference's Pallas ``cross_entropy`` (interpret mode on the CPU), values
and gradients, and the port's plain version against a step-by-step numpy
emulation of the kernel's fold order.

Inputs come from numpy with a seed. Cases: a ragged vocabulary (1000
columns, not a multiple of the port's 64-column steps or the reference's
1024-column tile at this width) and a padded one (2304 columns whose last
104 are the head's -1e30 pad logits, the chunked loss's form), whose loss
must equal that of the same logits cut to their 2200 real columns (the
serving head's form). On the CPU the port runs the kernel's plain
version.

Tolerance: both sides round p to bf16 before the ones-product row sum and
accumulate in f32, but at different running maxima (the port's warps each
keep one over their own 64- or 128-column steps of a 2048-column slice;
the reference keeps one a min(2048, round_up(V, 128))-column tile), so the
max at which a p is rounded differs, and even at the same tile the two exp
implementations may differ in the last f32 ulp and flip one rounding;
each such p can move by one bf16 rounding (2^-9 relative), so the loss
agrees within 2^-9 (relative change of l) ~ 2e-3 in the worst case
(observed 7e-4). The label logit is exact on both sides. Gradients are the same f32 host math
(softmax - onehot) on the same logits: 1e-6.

The partial variant (``cross_entropy_partial``, the vocab-parallel
cross-entropy of the sharded step): each rank's slice of the columns gives
(M, L, pick), and the slices merged in rank order (``merge_partials``) give
the full loss -- bitwise the full plain version where every rank holds one
whole 2048-column slice (the same folds in the same order), within the
reference tolerance's 2e-3 where a rank's slice ends inside one (the bf16
rounding of p at other maxima, as above) -- and the slices' gradients at
the exact logsumexp merged from their f32 statistics (``losses.exact_stats``,
``vocab_parallel_grad``) the full host gradient: 1e-6.

The emulation walks one row, one slice, one warp and one step at a time
in numpy f32 scalars; its exp is torch's f32 exp (numpy's differs from it
in the last ulp for many inputs, which would move the bf16 rounding of a p
near a rounding boundary), so both sides round every p at the same value
and differ only in the order of the f32 sums of a step's p (a few ulps of
l, up to four ulps of losses of ~10): 4e-6. Another fold order (other
warps, steps or slices) rounds p at other maxima and moved these losses
by 2e-4 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cross_entropy as ref_cross_entropy
from repro_torch.kernels import common, cross_entropy
from repro_torch.kernels.cross_entropy import (cross_entropy_bwd, cross_entropy_partial,
                                               cross_entropy_plain, merge_partials)
from repro_torch.models.losses import exact_stats, vocab_parallel_grad
from repro_torch.kernels.cross_entropy.ops import NEG, SLICE_V, WARPS, step_columns

ROWS = 24
PAD_FROM = 2200


def _inputs(vocab_width, seed=0, pad=False, rows=ROWS, pad_from=PAD_FROM):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, vocab_width)) * 3).astype(np.float32)
    labels = rng.integers(0, pad_from if pad else vocab_width, size=(rows,)).astype(np.int32)
    if pad:
        logits[:, pad_from:] = -1e30
    return logits, labels


def _exp(a):
    return torch.exp(torch.from_numpy(np.asarray(a, np.float32))).numpy()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate(logits: np.ndarray, labels: np.ndarray, itemsize: int) -> np.ndarray:
    """The kernel's fold order, one row, slice, warp and step at a time
    (csrc/cross_entropy.cu's header): each warp's running (m, l) over its
    steps, the warps merged in warp order, the slices in slice order."""
    f32 = np.float32
    rows, vocab = logits.shape
    step = step_columns(itemsize)
    out = np.zeros(rows, f32)
    for r in range(rows):
        slice_m, slice_l = [], []
        for j in range(-(-vocab // SLICE_V)):
            c_end = min((j + 1) * SLICE_V, vocab)
            warp_m, warp_l = [], []
            for w in range(WARPS):
                m, l = f32(NEG), f32(0.0)
                for c in range(j * SLICE_V + w * step, c_end, WARPS * step):
                    s = logits[r, c:min(c + step, vocab)]  # masked columns give p = 0
                    m_new = max(m, f32(s.max()))
                    p = _bf16(_exp(s - m_new))
                    l = f32(l * _exp(m - m_new)) + f32(p.sum(dtype=f32))
                    m = m_new
                warp_m.append(m)
                warp_l.append(l)
            big_m, big_l = f32(max(warp_m)), f32(0.0)
            for m, l in zip(warp_m, warp_l):
                big_l = f32(big_l + f32(l * _exp(m - big_m)))
            slice_m.append(big_m)
            slice_l.append(big_l)
        big_m, big_l = f32(max(slice_m)), f32(0.0)
        for m, l in zip(slice_m, slice_l):
            big_l = f32(big_l + f32(l * _exp(m - big_m)))
        lab = int(labels[r])
        pick = logits[r, lab] if 0 <= lab < vocab else f32(0.0)
        out[r] = f32(f32(big_m + f32(np.log(max(big_l, f32(1e-30))))) - pick)
    return out


@pytest.mark.parametrize("width,pad", [(1000, False), (2304, True)], ids=["ragged", "padded"])
def test_loss_matches_reference(width, pad):
    logits, labels = _inputs(width, pad=pad)
    want = np.asarray(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == (ROWS,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_padded_and_cut_widths_agree():
    # the chunked loss's padded head and the serving head's cut width give
    # the same loss: pad logits at -1e30 add exactly 0 to every tile
    logits, labels = _inputs(2304, seed=1, pad=True)
    padded = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    cut = cross_entropy(torch.from_numpy(logits[:, :PAD_FROM].copy()), torch.from_numpy(labels))
    np.testing.assert_allclose(cut.numpy(), padded.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("width,pad", [(1000, False), (2304, True)], ids=["ragged", "padded"])
def test_grad_matches_reference(width, pad):
    logits, labels = _inputs(width, seed=2, pad=pad)
    g = np.random.default_rng(3).standard_normal(ROWS).astype(np.float32)

    def ref_loss(lg):
        return jnp.sum(ref_cross_entropy(lg, jnp.asarray(labels)) * jnp.asarray(g))

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(logits)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    out = cross_entropy(lt, torch.from_numpy(labels))
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, lt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_leading_shape_and_plain_tiles():
    # any leading shape; one plain tile as wide as the vocab is the exact
    # online-softmax-free form: the tiled walk agrees with it
    logits, labels = _inputs(1000, seed=4)
    got = cross_entropy(torch.from_numpy(logits).view(4, 6, 1000),
                        torch.from_numpy(labels).view(4, 6))
    one_tile = cross_entropy_plain(torch.from_numpy(logits), torch.from_numpy(labels),
                                   slice_v=1024, warps=1, step_v=1024)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.reshape(-1).numpy(), one_tile.numpy(), rtol=0, atol=2e-3)


def test_cpu_path_counts_no_launch():
    logits, labels = _inputs(1000)
    before = common.launch_counts()
    cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert common.launch_counts() == before


@pytest.mark.parametrize("width,pad_from", [(1000, None), (2304, 2200), (4200, 4000)],
                         ids=["ragged", "padded", "all-pad-slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_walks_the_kernels_fold_order(width, pad_from, dtype):
    # 4200 columns make three slices, the last all pad logits
    logits, labels = _inputs(width, seed=5, pad=pad_from is not None, rows=19,
                             pad_from=pad_from or width)
    t = torch.from_numpy(logits).to(dtype)
    want = _emulate(t.float().numpy(), labels, t.element_size())
    got = cross_entropy_plain(t, torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6)


def test_all_pad_slice_adds_nothing():
    # a slice of only -1e30 logits has m = -1e30 and a nonzero l; its merge
    # term is exactly 0, so the padded width equals the cut one bitwise
    logits, labels = _inputs(4200, seed=6, pad=True, pad_from=4000)
    padded = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    cut = cross_entropy(torch.from_numpy(logits[:, :4000].copy()), torch.from_numpy(labels))
    assert torch.equal(cut, padded)
    want = np.asarray(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(padded.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("rows", [1, 5, 17])
def test_labels_at_the_edges_and_ragged_rows(rows):
    # rows not a multiple of 16; a label in the last partial step (column
    # 999 of a 960..1023 step), one below 0 and one past the vocabulary
    # (both pick 0, as the reference's one-hot hits nothing)
    logits, labels = _inputs(1000, seed=7, rows=rows)
    labels[0] = 999
    if rows > 1:
        labels[1] = -1
    if rows > 2:
        labels[2] = 1005
    want = np.asarray(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), _emulate(logits, labels, 4), rtol=0, atol=4e-6)


@pytest.mark.parametrize("width,ranks,pad", [(4096, 2, False), (6144, 3, False),
                                             (2304, 2, True), (1000, 4, False)],
                         ids=["2x2048", "3x2048", "padded-2x1152", "ragged-4x250"])
def test_partial_slices_merge_into_the_full_loss_and_gradient(width, ranks, pad):
    logits, labels = _inputs(width, seed=4, pad=pad)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    n = width // ranks
    common.reset_launches()
    parts = [cross_entropy_partial(x[:, r * n:(r + 1) * n], lab, r * n) for r in range(ranks)]
    assert cross_entropy_partial.launches == 0  # CPU operands: the plain version
    for r, part in enumerate(parts):
        assert part.shape == (ROWS, 3)
        lab_r = labels - r * n
        hit = (lab_r >= 0) & (lab_r < n)
        want = np.where(hit, logits[np.arange(ROWS), np.clip(labels, 0, width - 1)], 0.0)
        np.testing.assert_array_equal(part[:, 2].numpy(), want.astype(np.float32))
    loss, lse = merge_partials(parts)
    full = cross_entropy_plain(x, lab)
    if n % SLICE_V == 0:
        assert torch.equal(loss, full)
    else:
        np.testing.assert_allclose(loss.numpy(), full.numpy(), rtol=2e-3)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(ROWS).astype(np.float32))
    _, lse = merge_partials([exact_stats(x[:, r * n:(r + 1) * n]) for r in range(ranks)])
    grad = torch.cat([vocab_parallel_grad(x[:, r * n:(r + 1) * n], lab, lse, r * n, g)
                      for r in range(ranks)], -1)
    np.testing.assert_allclose(grad.numpy(), cross_entropy_bwd(x, lab, g).numpy(), atol=1e-6)


def test_partial_variant_refuses_bad_arguments():
    x, lab = torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="col0"):
        cross_entropy_partial(x, lab, -1)
    with pytest.raises(ValueError, match="expected"):
        cross_entropy_partial(x[None], lab, 0)
