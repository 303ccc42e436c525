"""Fused cross-entropy over the vocabulary: online logsumexp, ones-MMA
denominator, exact label logit.

Port of ``repro/kernels/cross_entropy`` (``_ce_kernel`` behind
``cross_entropy_call``, with the custom VJP of its ``ops.py``). Per row
(token) it streams the vocabulary in tiles of ``BLOCK_V`` columns and keeps
the running max ``m``, the denominator ``l = l * exp(m_old - m_new) +
rowsum(bf16(exp(s - m_new)))`` and the label's logit; the loss is
``m + log(max(l, 1e-30)) - pick``. Columns past the logits' width are
masked in the last tile, so a caller may pass the head's padded width (pad
logits at -1e30, as the chunked loss does) or the cut ``vocab_size``
width: both give the same loss.

On CUDA tensors ``cross_entropy`` launches ``csrc/cross_entropy.cu``; on CPU
tensors it runs ``cross_entropy_plain``, which walks the kernel's own
vocab tiles with the same running max, so p is rounded to bf16 at the same
values (the reference's tiles are 2048 wide; the rounding of p depends on
the running max at each tile, so the two agree to a stated tolerance, not
bitwise). The label logit is selected, not multiplied: the reference's
one-hot product is exact in f32, and a TF32 tensor-core product would
round it.

``cross_entropy`` is differentiable in the logits: its backward is
``(softmax - onehot) * g`` in f32, the reference's host math.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import bf16_round

NEG = -1e30
BLOCK_ROWS = 16   # csrc/cross_entropy.cu CE_ROWS: one m16 MMA tile of rows
BLOCK_V = 512     # csrc/cross_entropy.cu CE_BV: 8 warps x 64 columns


def cross_entropy_plain(logits: torch.Tensor, labels: torch.Tensor,
                        block_v: int = BLOCK_V) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (R, V) logits, (R,) int labels
    -> (R,) f32 per-row loss, walking ``block_v``-column tiles with the
    kernel's running max, masks and bf16 rounding of p."""
    rows, vocab = logits.shape
    dev = logits.device
    lf = logits.to(torch.float32)
    lab = labels.to(torch.int64)
    m = torch.full((rows,), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((rows,), dtype=torch.float32, device=dev)
    pick = torch.zeros((rows,), dtype=torch.float32, device=dev)
    for v0 in range(0, vocab, block_v):
        s = lf[:, v0:min(v0 + block_v, vocab)]
        vpos = v0 + torch.arange(s.shape[1], device=dev)
        hit = vpos[None, :] == lab[:, None]
        pick = pick + torch.sum(torch.where(hit, s, 0.0), -1)  # one term: exact
        m_new = torch.maximum(m, torch.amax(s, -1))
        p = torch.exp(s - m_new[:, None])
        l = l * torch.exp(m - m_new) + torch.sum(bf16_round(p), -1)
        m = m_new
    return m + torch.log(torch.clamp_min(l, 1e-30)) - pick


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d loss / d logits: ``(softmax - onehot) * g`` in f32, in the logits'
    dtype."""
    lf = logits.to(torch.float32)
    width = lf.shape[-1]
    p = torch.softmax(lf, -1)
    hit = torch.arange(width, device=lf.device) == labels.to(torch.int64)[..., None]
    p = torch.where(hit, p - 1.0, p)  # a label outside [0, width) hits nothing
    return (p * g.to(torch.float32)[..., None]).to(logits.dtype)


def _cross_entropy_forward(logits: torch.Tensor, labels: torch.Tensor):
    batch = logits.shape[:-1]
    width = logits.shape[-1]
    rows = logits.reshape(-1, width)
    lab = labels.reshape(-1)
    if common.on_cpu(rows, lab):
        return cross_entropy_plain(rows, lab).reshape(batch)
    if lab.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64; got {lab.dtype}")
    rows = rows.contiguous()
    lab = lab.to(torch.int32).contiguous()
    out = torch.empty((rows.shape[0],), dtype=torch.float32, device=rows.device)
    if rows.shape[0] >= 2**31:
        raise ValueError("too many rows for one launch")
    # pair loads need an even row stride and an 8-byte aligned base
    even = int(width % 2 == 0 and rows.data_ptr() % (2 * rows.element_size()) == 0)
    if rows.shape[0]:
        with torch.cuda.device(rows.device):
            err = build.library().ce_forward(
                rows.data_ptr(), lab.data_ptr(), out.data_ptr(), rows.shape[0], width,
                width, even, build.dtype_code(rows), build.stream_ptr(rows),
            )
        build.check(err, "cross_entropy")
        cross_entropy.launches += 1
    return out.reshape(batch)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _cross_entropy_forward(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, g), None


@common.counted("cross_entropy")
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE loss. logits: (..., V) float; labels: (...,) int. ->
    (...,) f32. CPU tensors: plain version; CUDA tensors: the kernel.
    Differentiable in the logits."""
    if logits.ndim < 1 or logits.shape[-1] < 1 or labels.shape != logits.shape[:-1]:
        raise ValueError(
            f"labels must have the logits' leading shape; got logits "
            f"{tuple(logits.shape)}, labels {tuple(labels.shape)}"
        )
    if common.needs_grad(logits):
        return _CrossEntropy.apply(logits, labels)
    return _cross_entropy_forward(logits, labels)
