"""Port parity: ``repro_torch.kernels.flash_attention`` against the
reference's Pallas ``flash_attention`` (interpret mode on the CPU).

Cases: causal and non-causal, GQA (Hq=4, Hkv=2), a sliding window, a
``q_offset``, and sequence lengths that are not block multiples. On the
CPU the port runs the kernel's plain version.

Heads 136, 200 and 256 wide take the kernel's wide variant on the card,
whose plain version walks 128-query, 64-key blocks (``blocks_for``); they
are held to the reference here at the same tolerance.

Tolerance 2e-3 (outputs are O(0.5)): both sides round q, k, v and the
probabilities p to bf16 and accumulate in f32, but the port streams 64-key
blocks where the reference streams 128-key blocks, so past 64 keys the
running max differs between the two when p is rounded -- one bf16 rounding
(2^-9 relative) of each p, not an error of the algorithm. At <= 64 keys the
two walk the same blocks and agree to f32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash_attention
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import flash_attention_plain, pad_head_dim

CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, q_offset
    pytest.param(1, 4, 4, 100, 100, 32, True, None, 0, id="causal-ragged"),
    pytest.param(1, 4, 2, 130, 130, 32, False, None, 0, id="noncausal-gqa-ragged"),
    pytest.param(1, 4, 2, 200, 200, 32, True, 64, 0, id="window-gqa"),
    pytest.param(1, 2, 2, 40, 200, 32, True, None, 160, id="q-offset"),
    pytest.param(1, 4, 1, 50, 90, 16, False, None, 0, id="mqa-cross-lengths"),
    pytest.param(2, 4, 4, 64, 64, 16, True, None, 0, id="one-block"),
    # heads past 128 wide: the wide variant's plain version (128 x 64 blocks)
    pytest.param(1, 2, 1, 70, 70, 256, True, None, 0, id="wide-256-mqa"),
    pytest.param(1, 2, 2, 40, 100, 200, True, 32, 60, id="wide-200-window-q-offset"),
    pytest.param(1, 4, 2, 60, 60, 136, False, None, 0, id="wide-136-gqa"),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,q_offset", CASES)
def test_matches_reference(b, hq, hkv, sq, skv, d, causal, window, q_offset):
    rng = np.random.default_rng(sq * 1000 + skv)
    q = (rng.standard_normal((b, hq, sq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, hkv, skv, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, hkv, skv, d)) * 0.5).astype(np.float32)
    want = np.asarray(ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, window=window, q_offset=q_offset,
    ))
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset,
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_bf16_inputs_keep_dtype():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 20, 16)).astype(np.float32)).to(torch.bfloat16)
    out = flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()


def test_rejects_bad_arguments():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)  # Hq not a multiple of Hkv
    with pytest.raises(ValueError):
        flash_attention(k, k, k, window=0)


@pytest.mark.parametrize("d", [8, 24])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_head_width_padding_matches_unpadded(d, hq, hkv):
    """The kernel takes head widths that are multiples of 16; the wrapper
    zero-pads any other width up to one (``pad_head_dim``) at the true
    scale d**-0.5 and keeps the first d columns. On the plain version the
    padded call agrees with the unpadded one (zero columns add nothing to
    q.k, and give zero output columns). dbrx-tiny's heads are 8 wide."""
    rng = np.random.default_rng(d * 10 + hq)
    q, k, v = (torch.from_numpy((rng.standard_normal((2, h, 70, d)) * 0.5)
                                .astype(np.float32)) for h in (hq, hkv, hkv))
    want = flash_attention_plain(q, k, v)
    padded = [pad_head_dim(t) for t in (q, k, v)]
    assert padded[0].shape[-1] == 16 * -(-d // 16)
    assert all(bool((t[..., d:] == 0).all()) for t in padded)
    out = flash_attention_plain(*padded, sm_scale=d**-0.5)
    assert bool((out[..., d:] == 0).all())
    torch.testing.assert_close(out[..., :d], want, rtol=0, atol=1e-6)
    # the entry on the CPU (the plain version, unpadded) agrees too
    torch.testing.assert_close(flash_attention(q, k, v), want, rtol=0, atol=0)


def test_blocks_follow_the_kernel_for_the_head_width():
    from repro_torch.kernels.flash_attention import blocks_for

    # up to 128 (after padding to a multiple of 16) the 128 x 128 kernel;
    # past it the wide variant's 128 x 64
    assert [blocks_for(d) for d in (8, 120, 128)] == [(128, 128)] * 3
    assert [blocks_for(d) for d in (129, 136, 200, 256)] == [(128, 64)] * 4
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 150, 144)).astype(np.float32))
               for _ in range(3))
    # the CPU wrapper runs the plain version with the wide variant's blocks
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_plain(q, k, v, block_q=128, block_k=64),
                               rtol=0, atol=0)
