"""Fused cross-entropy over the vocabulary: online logsumexp, ones-MMA
denominator, exact label logit.

Port of ``repro/kernels/cross_entropy`` (``_ce_kernel`` behind
``cross_entropy_call``, with the custom VJP of its ``ops.py``). Per row
(token) the loss is ``m + log(max(l, 1e-30)) - pick``: ``m`` the row max,
``l`` the sum of bf16-rounded ``exp(s - m)`` (the ones-MMA row sum) and
``pick`` the label's logit. Columns past the logits' width are masked, so a
caller may pass the head's padded width (pad logits at -1e30, as the
chunked loss does) or the cut ``vocab_size`` width: both give the same loss.

On CUDA tensors ``cross_entropy`` launches ``csrc/cross_entropy.cu``; on CPU
tensors it runs ``cross_entropy_plain``, which walks the kernel's own fold
order, so p is rounded to bf16 at the same running maxima:

  slices of ``SLICE_V`` columns (one CTA each per 16-row block), each cut
  into steps of ``step_columns(itemsize)`` columns dealt to ``WARPS`` warps
  in turn (step k to warp k % WARPS); each warp keeps a running max and sum
  over its own steps (``l = l * exp(m - m_new) + sum(bf16(exp(s - m_new)))``
  over the step's unmasked columns); the warps merge in warp order, then the
  slices in slice order, each by ``M = max m``, ``L = sum l * exp(m - M)``.

Every boundary sits at a column offset that does not depend on the width.
The kernel takes p by ``ex2.approx``, this version by ``torch.exp``: an ulp
or two apart, so the two agree to a stated tolerance, not bitwise. The
reference's tiles are 2048 wide with one running max a tile; the rounding
of p depends on the max at which it is taken, so the port and the
reference agree to a wider one. The label logit is selected, not
multiplied: the reference's one-hot product is exact in f32, and a TF32
tensor-core product would round it.

``cross_entropy`` is differentiable in the logits: its backward is
``(softmax - onehot) * g`` in f32, the reference's host math.

``cross_entropy_partial`` is the kernel's partial variant (``ce_partial``,
the same launch with another epilogue) for a vocabulary cut over ranks:
its logits are the columns [col0, col0 + V) of the whole, and it returns
per row the slice's (M, L, pick) -- max, sum of exp(s - M) and the label's
logit when the label falls in the slice, else 0 -- which
``merge_partials`` folds across the slices in rank order into the loss.
``cross_entropy_partial_plain`` walks the same order on the CPU. Not
differentiable itself: ``models.losses`` wraps it with its merge.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import bf16_round

NEG = -1e30
BLOCK_ROWS = 16   # csrc/cross_entropy.cu CE_ROWS: one m16 MMA tile of rows
WARPS = 4         # CE_WARPS: the warps of a CTA, each with its own running max
SLICE_V = 2048    # CE_SLICE: the columns of one CTA


def step_columns(itemsize: int) -> int:
    """Columns of one warp step (csrc/cross_entropy.cu ``step_cols``): four
    threads of a quad, four 16-byte chunks each: 64 f32 or 128 bf16 / f16."""
    return 4 * 4 * (16 // itemsize)


def _plain_stats(logits: torch.Tensor, slice_v: int, warps: int, step_v: int | None):
    """The kernel's (M, L) of each row in its fold order, and the padded
    f32 logits."""
    rows, vocab = logits.shape
    step_v = step_v or step_columns(logits.element_size())
    if slice_v % (warps * step_v):
        raise ValueError(f"a slice of {slice_v} columns is not whole rounds of {warps} warp "
                         f"steps of {step_v}")
    dev = logits.device
    slices, steps = common.ceil_div(vocab, slice_v), slice_v // (warps * step_v)
    width = slices * slice_v
    lf = torch.nn.functional.pad(logits.to(torch.float32), (0, width - vocab), value=NEG)
    x = lf.view(rows, slices, steps, warps, step_v)
    valid = (torch.arange(width, device=dev) < vocab).view(slices, steps, warps, step_v)
    m = torch.full((rows, slices, warps), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((rows, slices, warps), dtype=torch.float32, device=dev)
    for s in range(steps):  # 1. each warp over its steps
        ok = valid[:, s]
        v = torch.where(ok, x[:, :, s], NEG)
        m_new = torch.maximum(m, torch.amax(v, -1))
        p = torch.where(ok, torch.exp(v - m_new[..., None]), 0.0)
        l = l * torch.exp(m - m_new) + torch.sum(bf16_round(p), -1)
        m = m_new
    mj = torch.amax(m, -1)  # 2. the warps in warp order
    lj = torch.zeros_like(mj)
    for w in range(warps):
        lj = lj + l[..., w] * torch.exp(m[..., w] - mj)
    big_m = torch.amax(mj, -1)  # 3. the slices in slice order
    big_l = torch.zeros_like(big_m)
    for j in range(slices):
        big_l = big_l + lj[:, j] * torch.exp(mj[:, j] - big_m)
    return big_m, big_l, lf


def _pick(lf: torch.Tensor, labels: torch.Tensor, vocab: int, col0: int = 0) -> torch.Tensor:
    """The label's logit (label - col0 in [0, vocab)), else 0."""
    lab = labels.to(torch.int64) - col0
    hit = (lab >= 0) & (lab < vocab)
    return torch.where(hit, torch.gather(lf, 1, torch.where(hit, lab, 0)[:, None])[:, 0], 0.0)


def cross_entropy_plain(logits: torch.Tensor, labels: torch.Tensor, slice_v: int = SLICE_V,
                        warps: int = WARPS, step_v: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (R, V) logits, (R,) int labels
    -> (R,) f32 per-row loss, in the kernel's fold order (module doc):
    ``slice_v``-column slices, ``step_v``-column steps (by default the
    kernel's for the logits' dtype) dealt to ``warps`` warps in turn, each
    warp's running max, masks and bf16 rounding of p, then the warps and
    the slices merged in order. A label outside [0, V) picks 0."""
    big_m, big_l, lf = _plain_stats(logits, slice_v, warps, step_v)
    pick = _pick(lf, labels, logits.shape[1])
    return big_m + torch.log(torch.clamp_min(big_l, 1e-30)) - pick


def cross_entropy_partial_plain(logits: torch.Tensor, labels: torch.Tensor, col0: int,
                                slice_v: int = SLICE_V, warps: int = WARPS,
                                step_v: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the partial variant: (R, V) logits, the
    columns [col0, col0 + V) of a vocabulary, (R,) global int labels ->
    (R, 3) f32, (M, L, pick) a row, in the kernel's fold order."""
    big_m, big_l, lf = _plain_stats(logits, slice_v, warps, step_v)
    return torch.stack([big_m, big_l, _pick(lf, labels, logits.shape[1], col0)], -1)


def merge_partials(parts: list) -> tuple:
    """Slices' (R, 3) triples in rank order -> (loss (R,), lse (R,)): M =
    max M_r, L = sum in order L_r exp(M_r - M) (each term one rounded
    product), lse = M + log(max(L, 1e-30)), loss = lse - sum of picks
    (one nonzero: exact)."""
    big_m = parts[0][:, 0]
    for p in parts[1:]:
        big_m = torch.maximum(big_m, p[:, 0])
    big_l = torch.zeros_like(big_m)
    pick = torch.zeros_like(big_m)
    for p in parts:
        big_l = big_l + p[:, 1] * torch.exp(p[:, 0] - big_m)
        pick = pick + p[:, 2]
    lse = big_m + torch.log(torch.clamp_min(big_l, 1e-30))
    return lse - pick, lse


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
        common.record_io(cross_entropy, (common.nbytes(rows, lab), 4 * rows.shape[0]), plain=True)
        return cross_entropy_plain(rows, lab).reshape(batch)
    if lab.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64; got {lab.dtype}")
    rows = rows.contiguous()
    lab = lab.to(torch.int32).contiguous()
    out = torch.empty((rows.shape[0],), dtype=torch.float32, device=rows.device)
    if rows.shape[0] >= 2**31:
        raise ValueError("too many rows for one launch")
    # 16-byte loads need a 16-byte aligned base and row stride
    vec = int(rows.data_ptr() % 16 == 0 and width * rows.element_size() % 16 == 0)
    blocks = common.ceil_div(rows.shape[0], BLOCK_ROWS)
    slices = common.ceil_div(width, SLICE_V)
    part = torch.empty((blocks * slices * BLOCK_ROWS * 2,) if slices > 1 else (0,),
                       dtype=torch.float32, device=rows.device)
    if rows.shape[0]:
        stream = build.stream_ptr(rows)
        ticket = common.fold_tickets("cross_entropy", rows.device, stream, count=blocks)
        with torch.cuda.device(rows.device):
            err = build.library().ce_forward(
                rows.data_ptr(), lab.data_ptr(), out.data_ptr(), rows.shape[0], width,
                width, vec, build.dtype_code(rows), part.data_ptr() if slices > 1 else None,
                ticket.data_ptr(), stream,
            )
        build.check(err, "cross_entropy")
        # logits and labels in, the losses out; the slices' partials out and
        # back into each row block's last CTA
        common.record_io(cross_entropy, (common.nbytes(rows, lab, part),
                                         common.nbytes(out, part)))
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


@common.counted("cross_entropy_partial")
def cross_entropy_partial(logits: torch.Tensor, labels: torch.Tensor, col0: int) -> torch.Tensor:
    """K7's partial variant. logits: (R, V) float, the columns [col0, col0
    + V) of a vocabulary; labels: (R,) int global ids -> (R, 3) f32, (M,
    L, pick) a row. CPU tensors: plain version; CUDA tensors: the kernel
    (one launch). Not differentiable."""
    if logits.ndim != 2 or logits.shape[1] < 1 or labels.shape != logits.shape[:1]:
        raise ValueError(f"expected (R, V) logits and (R,) labels; got {tuple(logits.shape)}, "
                         f"{tuple(labels.shape)}")
    if col0 < 0:
        raise ValueError(f"col0 must be >= 0; got {col0}")
    rows, width = logits.shape
    if common.on_cpu(logits, labels):
        common.record_io(cross_entropy_partial, (common.nbytes(logits, labels), 12 * rows),
                         plain=True)
        return cross_entropy_partial_plain(logits, labels, col0)
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64; got {labels.dtype}")
    x = logits.contiguous()
    lab = labels.to(torch.int32).contiguous()
    out = torch.empty((rows, 3), dtype=torch.float32, device=x.device)
    vec = int(x.data_ptr() % 16 == 0 and width * x.element_size() % 16 == 0)
    blocks = common.ceil_div(rows, BLOCK_ROWS)
    slices = common.ceil_div(width, SLICE_V)
    part = torch.empty((blocks * slices * BLOCK_ROWS * 2,) if slices > 1 else (0,),
                       dtype=torch.float32, device=x.device)
    if rows:
        stream = build.stream_ptr(x)
        ticket = common.fold_tickets("cross_entropy", x.device, stream, count=blocks)
        with torch.cuda.device(x.device):
            err = build.library().ce_partial(
                x.data_ptr(), lab.data_ptr(), out.data_ptr(), rows, width, width, int(col0),
                vec, build.dtype_code(x), part.data_ptr() if slices > 1 else None,
                ticket.data_ptr(), stream)
        build.check(err, "cross_entropy_partial")
        common.record_io(cross_entropy_partial, (common.nbytes(x, lab, part),
                                                 common.nbytes(out, part)))
    return out
