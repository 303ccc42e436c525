"""Port parity: ``repro_torch.kernels.cross_entropy`` (K7) against the
reference's Pallas ``cross_entropy`` (interpret mode on the CPU), values
and gradients.

Inputs come from numpy with a seed. Cases: a ragged vocabulary (1000
columns, not a multiple of the port's 512-column tiles or the reference's
1024-column tile at this width) and a padded one (2304 columns whose last
104 are the head's -1e30 pad logits, the chunked loss's form), whose loss
must equal that of the same logits cut to their 2200 real columns (the
serving head's form). On the CPU the port runs the kernel's plain
version.

Tolerance: both sides round p to bf16 before the ones-product row sum and
accumulate in f32, but at different tile boundaries (512 vs the
reference's min(2048, round_up(V, 128)) columns), so the running max at
which a p is rounded differs, and even at the same tile the two exp
implementations may differ in the last f32 ulp and flip one rounding;
each such p can move by one bf16 rounding (2^-9 relative), so the loss
agrees within 2^-9 (relative change of l) ~ 2e-3 in the worst case
(observed 7e-4). The label logit is exact on both sides. Gradients are the same f32 host math
(softmax - onehot) on the same logits: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cross_entropy as ref_cross_entropy
from repro_torch.kernels import common, cross_entropy
from repro_torch.kernels.cross_entropy import cross_entropy_plain

ROWS = 24
PAD_FROM = 2200


def _inputs(vocab_width, seed=0, pad=False):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((ROWS, vocab_width)) * 3).astype(np.float32)
    labels = rng.integers(0, PAD_FROM if pad else vocab_width, size=(ROWS,)).astype(np.int32)
    if pad:
        logits[:, PAD_FROM:] = -1e30
    return logits, labels


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
                                   block_v=1024)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.reshape(-1).numpy(), one_tile.numpy(), rtol=0, atol=2e-3)


def test_cpu_path_counts_no_launch():
    logits, labels = _inputs(1000)
    before = common.launch_counts()
    cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert common.launch_counts() == before
