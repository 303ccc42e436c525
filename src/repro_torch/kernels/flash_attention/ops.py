"""Flash attention forward with an all-ones-MMA softmax denominator.

Port of ``repro/kernels/flash_attention`` (``_attn_kernel`` behind
``flash_attention``). Layout at this function, as in the reference:
q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D); Hq a multiple of Hkv (GQA).
On CUDA tensors the wrapper launches ``csrc/flash_attention.cu`` (a head
width off the multiples of 16 zero-padded to one first; past 128 wide the
kernel hands the call to its wide variant, ``csrc/flash_attention_wide.cu``:
the same warp-specialized ``wgmma`` and TMA design at 128 queries by 64
keys, its MMAs always 256 columns wide, the columns past d read as zeros);
on CPU tensors it runs ``flash_attention_plain``, which walks the same
blocks (``blocks_for``: 128 queries and 128 keys, the reference's
``block_q`` and ``block_k``, up to d = 128; 128 and 64 past it) with the
same run test, masks, bf16 roundings and online update. Heads wider than
256 are refused on the card.

``flash_attention_diff`` is the differentiable entry, the counterpart of
the reference's custom-VJP ``flash_attention_diff``: the kernel forward,
and a backward that recomputes attention densely through
``attention_ref`` (the reference's ``_bwd``; FlashAttention's recompute
strategy, no residual but q, k, v). ``flash_attention`` itself goes
through it whenever grad mode is on and an input requires grad.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import bf16_round

NEG = -1e30
LOG2E = math.log2(math.e)  # the kernel's softmax runs in base 2
BLOCK_Q = 128   # csrc/flash_attention.cu FA_BQ
BLOCK_K = 128   # csrc/flash_attention.cu FA_BK
NARROW_HEAD_DIM = 128  # csrc/flash_attention.cu FA_DMAX: wider heads take the wide variant
WIDE_BLOCK_Q = 128  # csrc/flash_attention_wide.cu FW_BQ: two consumer warpgroups of 64 rows
WIDE_BLOCK_K = 64   # csrc/flash_attention_wide.cu FW_BK: S = Q K^T as wgmma m64n64
MAX_HEAD_DIM = 256  # csrc/flash_attention_wide.cu FW_DMAX: every MMA runs over 256 columns
HEAD_DIM_MULTIPLE = 16  # the kernel's MMA k-step over the head width


def blocks_for(d: int) -> tuple:
    """(block_q, block_k) of the kernel that takes heads ``d`` wide (after
    ``pad_head_dim``): 128 x 128 up to 128, the wide variant's 128 x 64
    past it."""
    if d + (-d) % HEAD_DIM_MULTIPLE > NARROW_HEAD_DIM:
        return WIDE_BLOCK_Q, WIDE_BLOCK_K
    return BLOCK_Q, BLOCK_K


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., D) zero-padded on its last axis to the next multiple of
    16, the head widths the kernel takes. Zero columns add nothing to q.k
    and give zero output columns, so the first D columns of attention over
    the padded q, k, v (at the true scale D**-0.5) are attention over the
    unpadded ones."""
    return torch.nn.functional.pad(t, (0, (-t.shape[-1]) % HEAD_DIM_MULTIPLE))


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    sm_scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the online softmax over
    ``block_k``-key blocks, each q block skipping the k blocks the kernel's
    run test skips (the blocks default to the kernel's for this head
    width, ``blocks_for``). Products of bf16-rounded operands accumulate in f32;
    the softmax runs in base 2, as the kernel's does (s = q.k * scale *
    log2 e, p = 2^(s - m): e^(scale q.k - scale m))."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    block_q = block_q or blocks_for(d)[0]
    block_k = block_k or blocks_for(d)[1]
    scale = (sm_scale if sm_scale is not None else d**-0.5) * LOG2E
    rep = hq // hkv
    dev = q.device
    qf = bf16_round(q)
    kf = bf16_round(k).repeat_interleave(rep, dim=1)
    vf = bf16_round(v).repeat_interleave(rep, dim=1)
    qpos = q_offset + torch.arange(sq, device=dev)
    qpos0 = q_offset + (torch.arange(sq, device=dev) // block_q) * block_q
    m = torch.full((b, hq, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        # the kernel's run test, per q block (kv_len == skv here)
        run = torch.full((sq,), k0 < skv, device=dev)
        if causal:
            run &= k0 <= qpos0 + block_q - 1
        if window is not None:
            run &= qpos0 - (k0 + block_k - 1) < window
        if not bool(run.any()):
            continue
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        kpos = k0 + torch.arange(kb.shape[2], device=dev)
        mask = (kpos[None, :] < skv).expand(sq, -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp2(s - m_new[..., None]), 0.0)
        alpha = torch.exp2(m - m_new)
        pb = bf16_round(p)
        l_new = l * alpha + pb.sum(-1)
        acc_new = acc * alpha[..., None] + torch.matmul(pb, vb)
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run[:, None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense attention in f32 (port of ``ref.attention_ref``): query i sits
    at absolute position q_offset + i, key j at j; causal keeps key <=
    query, a window W keeps query - key < W."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d**-0.5
    rep = hq // hkv
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.to(torch.float32), kk.to(torch.float32).transpose(-1, -2)) * sm_scale
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - torch.amax(s, -1, keepdim=True))
    p = p / torch.clamp_min(torch.sum(p, -1, keepdim=True), 1e-30)
    out = torch.matmul(p, vv.to(torch.float32))
    return out.to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, sm_scale=sm_scale)
        # through the counted wrapper (grad mode is off here), so the meter
        # sees this forward as the kernel's work
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
            out = attention_ref(*leaves, **ctx.kw)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None


def flash_attention_diff(q, k, v, causal=True, window=None, q_offset=0, sm_scale=None):
    """Differentiable attention: the kernel forward (or its plain version
    on CPU tensors), backward by dense recompute through ``attention_ref``.
    Same argument order as the reference's ``flash_attention_diff``."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset, sm_scale)


@common.counted("flash_attention")
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """IO-aware attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).
    CPU tensors: plain version; CUDA tensors: the kernel (any D up to 256:
    a D that is not a multiple of 16 is zero-padded to one inside the
    wrapper, ``pad_head_dim``; past 128 the kernel's wide variant runs;
    past 256 the call is refused). With an input that needs a gradient, the
    call goes through ``flash_attention_diff``."""
    if common.needs_grad(q, k, v):
        return flash_attention_diff(q, k, v, causal, window, q_offset, sm_scale)
    return _flash_attention_forward(
        q, k, v, causal=causal, window=window, q_offset=q_offset, sm_scale=sm_scale
    )


def _flash_attention_forward(q, k, v, *, causal, window, q_offset, sm_scale):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if sm_scale is None:
        sm_scale = d**-0.5
    if common.on_cpu(q, k, v):
        common.record_io(flash_attention, (common.nbytes(q, k, v), common.nbytes(q)), plain=True)
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset, sm_scale=sm_scale
        )
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes D up to {MAX_HEAD_DIM}; got {d} (no "
                         "configuration of the repository has wider heads)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if d % HEAD_DIM_MULTIPLE:
        # the padded copy is this call's own work; sm_scale stays d**-0.5
        out = _flash_attention_forward(
            pad_head_dim(q), pad_head_dim(k), pad_head_dim(v), causal=causal, window=window,
            q_offset=q_offset, sm_scale=sm_scale)
        return out[..., :d].contiguous()
    # the kernel reads 16-byte aligned rows (TMA, vector loads): a view
    # that starts off that alignment is copied
    qc, kc, vc = (t.reshape(n, s, d).contiguous() for t, n, s in
                  ((q, b * hq, sq), (k, b * hkv, skv), (v, b * hkv, skv)))
    qc, kc, vc = (t.clone() if t.data_ptr() % 16 else t for t in (qc, kc, vc))
    out = torch.empty_like(qc)
    if qc.numel() and skv:
        with torch.cuda.device(q.device):
            err = build.library().fa_forward(
                qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                b * hq, sq, skv, d, hq, hkv, float(sm_scale) * LOG2E, int(bool(causal)),
                -1 if window is None else int(window), int(q_offset), skv,
                build.dtype_code(qc), build.stream_ptr(qc),
            )
        build.check(err, "flash_attention")
        common.record_io(flash_attention, (common.nbytes(qc, kc, vc), common.nbytes(out)))
    elif qc.numel():
        out.zero_()  # no keys: acc = 0 -> 0 / max(0, 1e-30)
    return out.reshape(b, hq, sq, d)
