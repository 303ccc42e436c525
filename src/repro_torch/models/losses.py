"""Training losses: the per-token cross-entropy and the token mean.

Port of ``repro/models/losses.py``. With ``cfg.use_kernels`` the per-token
CE is the fused kernel (``kernels.cross_entropy``, K7); without it the
logsumexp's denominator is a row reduction of the engine. The token sum of
the chunked loss is a full reduction of the engine: one launch of the fused
kernel (K1) on cuda_fused.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels as K
from repro_torch import reduce as R


def cross_entropy_tokens(logits, labels, *, mma: bool, use_kernels: bool = False):
    """Per-token CE. logits: (..., V) f32; labels: (...,) int."""
    if use_kernels:
        return K.cross_entropy(logits, labels)
    lf = logits.to(torch.float32)
    m = torch.amax(lf, -1)
    e = torch.exp(lf - m[..., None])
    denom = R.reduce(e, axis=-1, backend=R.backend_for_flags(mma))
    lse = m + torch.log(torch.clamp_min(denom, 1e-30))
    picked = torch.take_along_dim(lf, labels.to(torch.int64)[..., None], -1)[..., 0]
    return lse - picked


def lm_loss(logits, labels, aux, cfg):
    """Mean next-token loss (+ aux). logits (B, S, V) with labels (B, S),
    or (B, S, K, V) with (B, S, K): the mean over every token and stream."""
    per_tok = cross_entropy_tokens(
        logits, labels, mma=cfg.mma_reductions, use_kernels=cfg.use_kernels
    )
    mean = R.reduce(per_tok, kind="mean", backend=R.backend_for_flags(cfg.mma_reductions))
    return mean + aux, {"ce": mean, "aux": aux}


def lm_loss_chunked(params, cfg, h, labels, aux, *, seq_chunk: int = 512):
    """Memory-bounded LM loss: the head projection and the CE run per
    sequence chunk under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scan body), so the (B, S, V) logits never
    exist -- one (B, seq_chunk, V) f32 tile at a time, recomputed in the
    backward pass. h: final normed hidden (B, S, d); labels: (B, S), or
    (B, S, K) with K codebook streams, whose per-token CE is averaged over
    K before the mask and the token sum, as the reference's is. The pad
    goes on the sequence axis."""
    from repro_torch.models.model import _head  # padded + masked head

    b, s, _ = h.shape
    chunk = min(seq_chunk, s)
    pad = (-s) % chunk
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad))
    lp = torch.nn.functional.pad(labels, (0, 0) * (labels.ndim - 2) + (0, pad))
    # padded positions are masked out of the mean
    mask = torch.nn.functional.pad(torch.ones((b, s), dtype=torch.float32, device=h.device),
                                   (0, pad))
    backend = R.backend_for_flags(cfg.mma_reductions)

    def body(hcb, lcb, mcb):
        logits = _head(params, cfg, hcb)
        per_tok = cross_entropy_tokens(
            logits, lcb, mma=cfg.mma_reductions, use_kernels=cfg.use_kernels
        )
        if per_tok.ndim == 3:  # codebook streams: the mean over K
            per_tok = torch.mean(per_tok, -1)
        return R.reduce(per_tok * mcb, backend=backend)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(body, hp[:, sl], lp[:, sl], mask[:, sl], use_reentrant=False)
    mean = total / (b * s)
    return mean + aux, {"ce": mean, "aux": aux}
