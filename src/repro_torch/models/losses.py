"""Training losses: the per-token cross-entropy and the token mean.

Port of ``repro/models/losses.py``. With ``cfg.use_kernels`` the per-token
CE is the fused kernel (``kernels.cross_entropy``, K7); without it the
logsumexp's denominator is a row reduction of the engine. The token sum of
the chunked loss is a full reduction of the engine: one launch of the fused
kernel (K1) on cuda_fused.

Under a sharded step's plan whose vocabulary is cut over "model"
(``models.parallel``), each rank holds its slice of the logits: its
per-row (max, sum of exp, label logit if the label is in the slice) come
from K7's partial variant (``kernels.cross_entropy_partial``; without the
kernels, the engine's row reduction), are gathered over "model" and merged
in rank order into the loss; the backward is ``softmax - onehot`` on the
rank's columns at the exact f32 logsumexp, merged the same way. With K
codebook streams the rows are B x S x K (each stream's label against its
own head's columns), and the mean over K follows the merge.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels as K
from repro_torch import reduce as R
from repro_torch.core import collectives as C
from repro_torch.kernels.cross_entropy import merge_partials


def _partial_stats(logits, labels, col0: int, mma: bool, use_kernels: bool):
    """(R, V) logits of the columns [col0, col0 + V), (R,) global labels ->
    (R, 3) f32: (max, sum of exp(s - max), the label's logit or 0)."""
    if use_kernels:
        return K.cross_entropy_partial(logits, labels, col0)
    lf = logits.to(torch.float32)
    m = torch.amax(lf, -1)
    denom = R.reduce(torch.exp(lf - m[..., None]), axis=-1, backend=R.backend_for_flags(mma))
    lab = labels.to(torch.int64) - col0
    hit = (lab >= 0) & (lab < lf.shape[-1])
    pick = torch.where(hit, torch.gather(lf, -1, torch.where(hit, lab, 0)[..., None])[..., 0],
                       0.0)
    return torch.stack([m, denom, pick], -1)


def exact_stats(logits) -> torch.Tensor:
    """(R, V) logits -> (R, 3) f32: the max, the f32 sum of exp(s - max),
    and 0 in the pick's place (``merge_partials`` of the slices' rows gives
    the exact logsumexp, the host softmax's denominator)."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, -1)
    l = torch.sum(torch.exp(lf - m[..., None]), -1)
    return torch.stack([m, l, torch.zeros_like(m)], -1)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE over a vocabulary cut over ``axis``: the rank's slice
    statistics gathered over the axis and merged in rank order. The
    backward is the reference's host math, ``(softmax - onehot) * g``, on
    the rank's columns: its softmax denominator is the exact f32 one, the
    slices' ``exact_stats`` gathered and merged the same way (the kernel's
    sum rounds p to bf16, which the host softmax does not)."""

    @staticmethod
    def forward(ctx, logits, labels, col0, mesh, axis, mma, use_kernels):
        rows = logits.reshape(-1, logits.shape[-1])
        stats = _partial_stats(rows, labels.reshape(-1), col0, mma, use_kernels)
        loss, _ = merge_partials(C._all_gather(stats, axis, mesh, kind="all-gather"))
        ctx.save_for_backward(logits, labels)
        ctx.col0, ctx.mesh, ctx.axis = col0, mesh, axis
        return loss.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        stats = exact_stats(logits.reshape(-1, logits.shape[-1]))
        _, lse = merge_partials(C._all_gather(stats, ctx.axis, ctx.mesh, kind="all-gather"))
        return vocab_parallel_grad(logits, labels, lse.reshape(labels.shape), ctx.col0,
                                   g), *(None,) * 6


def vocab_parallel_grad(logits, labels, lse, col0: int, g):
    """d loss / d logits on a slice [col0, col0 + V) of the vocabulary:
    ``(exp(s - lse) - onehot) * g`` in f32 at the whole row's logsumexp,
    in the logits' dtype (``kernels.cross_entropy_bwd`` of a slice)."""
    lf = logits.to(torch.float32)
    p = torch.exp(lf - lse[..., None])
    cols = col0 + torch.arange(lf.shape[-1], device=lf.device)
    p = torch.where(cols == labels.to(torch.int64)[..., None], p - 1.0, p)
    return (p * g.to(torch.float32)[..., None]).to(logits.dtype)


def cross_entropy_tokens(logits, labels, *, mma: bool, use_kernels: bool = False, plan=None):
    """Per-token CE. logits: (..., V) f32; labels: (...,) int. Under a
    ``plan`` whose vocabulary is cut over "model", logits are the rank's
    columns (from ``plan.vocab0``) and the loss the merged one."""
    if plan is not None and plan.vocab_parallel:
        return _VocabParallelCE.apply(logits, labels, plan.vocab0, plan.mesh, plan.model, mma,
                                      use_kernels)
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


def lm_loss_chunked(params, cfg, h, labels, aux, *, seq_chunk: int = 512, plan=None):
    """Memory-bounded LM loss: the head projection and the CE run per
    sequence chunk under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scan body), so the (B, S, V) logits never
    exist -- one (B, seq_chunk, V) f32 tile at a time, recomputed in the
    backward pass. h: final normed hidden (B, S, d); labels: (B, S), or
    (B, S, K) with K codebook streams, whose per-token CE is averaged over
    K before the mask and the token sum, as the reference's is. The pad
    goes on the sequence axis. ``plan``: the sharded step's
    (``models.parallel.Plan``); h and labels are the rank's rows, and the
    mean is theirs."""
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
        logits = _head(params, cfg, hcb, plan)
        per_tok = cross_entropy_tokens(
            logits, lcb, mma=cfg.mma_reductions, use_kernels=cfg.use_kernels, plan=plan
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
