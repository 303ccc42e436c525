"""Shared layers: norms, FFNs, RoPE, the causal depthwise conv.

Port of ``repro/models/layers.py`` (``norm_apply``, ``rmsnorm_apply_many``,
``softmax_mma``, ``ffn_apply``, ``rope``, ``causal_conv1d``,
``conv1d_step``). With ``use_kernels`` the norms run the fused kernels of
``kernels.row_moments`` (the reference's ``use_pallas`` route); without it
their f32 row statistics are row reductions of the engine on
``backend_for_flags(mma)`` -- the ones-MMA route with the paper's technique
on, plain ``torch`` with it off -- and the normalization is applied in the
activation dtype, as the reference applies it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch import reduce as R
from repro_torch.models import params as P


def norm_apply(kind: str, p: dict, x: torch.Tensor, *, eps: float, mma: bool,
               use_kernels: bool = False, tp=None) -> torch.Tensor:
    """``tp`` (``models.parallel.TP``; an RMSNorm on the engine's route):
    ``x`` and the scale hold a rank's block of each row's channels, and
    the row's sum of squares is the ranks' summed over ``tp`` both ways
    (``tp.both``), over the whole width."""
    if use_kernels and tp is None:
        if kind == "rmsnorm":
            return K.rmsnorm(x, p["scale"], eps)
        if kind == "layernorm_np":
            return K.layernorm_np(x, eps)
    xf = x.to(torch.float32)
    d = x.shape[-1]
    backend = R.backend_for_flags(mma)
    if kind == "rmsnorm":
        # bf16 multipliers with f32 accumulation on the MMA route
        ss = R.reduce(xf, axis=-1, kind="sumsq", backend=backend,
                      compute_dtype="bfloat16" if mma else None)
        if tp is not None:
            ss, d = tp.both(ss), d * tp.mesh.axis_size(tp.axis)
        rstd = torch.rsqrt(ss / d + eps).to(x.dtype)
        return x * rstd[..., None] * p["scale"].to(x.dtype)
    if kind in ("layernorm", "layernorm_np"):
        s, ss = R.reduce(xf, axis=-1, kind="moments", backend=backend)
        mu = s / d
        var = torch.clamp_min(ss / d - mu * mu, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = (x - mu[..., None].to(x.dtype)) * rstd[..., None].to(x.dtype)
        if kind == "layernorm":
            y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
        return y
    raise ValueError(f"norm {kind!r} is not ported")


def rmsnorm_apply_many(ps, xs, *, eps: float, mma: bool) -> list:
    """N independent RMSNorms with every statistic in ONE pass: the rows'
    f32 sums of squares of all of them through one ``reduce_many(axis=-1)``
    on ``backend_for_flags(mma)`` (bf16 multipliers with f32 accumulation
    on the MMA route, as ``norm_apply``'s), then each normalization in its
    input's dtype. The same numerics as N ``norm_apply("rmsnorm", ...)``
    calls on the engine's route (zero-padding to the widest row is exact
    under f32 accumulation)."""
    sss = R.reduce_many([x.to(torch.float32) for x in xs], kind="sumsq", axis=-1,
                        backend=R.backend_for_flags(mma),
                        compute_dtype="bfloat16" if mma else None)
    out = []
    for p, x, ss in zip(ps, xs, sss):
        rstd = torch.rsqrt(ss / x.shape[-1] + eps).to(x.dtype)
        out.append(x * rstd[..., None] * p["scale"].to(x.dtype))
    return out


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products at full f32 inside the block (no TF32 on the card):
    for products the reference takes in f32 where TF32's 10-bit mantissa
    would move a result (MoE routing decisions, MLA's absorbed decode)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def softmax_mma(s: torch.Tensor, *, mma: bool, axis: int = -1) -> torch.Tensor:
    """Softmax whose denominator is a row reduction of the engine on
    ``backend_for_flags(True)`` when ``mma`` (the ones-product), else
    ``torch.sum``. The max-subtraction stays an f32 elementwise op (max has
    no '+' MMA encoding); the denominator is floored at 1e-30."""
    sf = s.to(torch.float32)
    m = torch.amax(sf, dim=axis, keepdim=True)
    e = torch.exp(sf - m)
    if mma and axis in (-1, s.ndim - 1):
        denom = R.reduce(e, axis=-1, backend=R.backend_for_flags(True))[..., None]
    else:
        denom = torch.sum(e, dim=axis, keepdim=True)
    return (e / torch.clamp_min(denom, 1e-30)).to(s.dtype)


def ffn_init(gen, d: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind == "swiglu":
        return {
            "gate": P.dense_init(gen, d, d_ff, dtype, device),
            "up": P.dense_init(gen, d, d_ff, dtype, device),
            "down": P.dense_init(gen, d_ff, d, dtype, device),
        }
    if kind == "gelu":
        return {"up": P.dense_init(gen, d, d_ff, dtype, device),
                "down": P.dense_init(gen, d_ff, d, dtype, device)}
    raise ValueError(f"ffn {kind!r} is not ported")


def ffn_apply(p: dict, x: torch.Tensor, kind: str, tp=None) -> torch.Tensor:
    """SwiGLU, down(silu(x @ gate) * (x @ up)), or GELU, down(gelu(x @
    up)) with the tanh form of the GELU (``jax.nn.gelu``'s default).
    ``tp`` (``models.parallel.TP``): gate and up hold a rank's columns
    (column-parallel, x through ``tp.enter``), down its rows (row-parallel,
    the partial sums through ``tp.exit``)."""
    if tp is not None:
        return tp.exit(ffn_apply(p, tp.enter(x), kind))
    if kind == "swiglu":
        h = F.silu(P.dense_apply(p["gate"], x)) * P.dense_apply(p["up"], x)
    else:
        h = F.gelu(P.dense_apply(p["up"], x), approximate="tanh")
    return P.dense_apply(p["down"], h)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in f32. x: (B, L, C); w: (K, C) -> (B, L, C)
    in x's dtype: out[t] = sum_k w[k] x[t - (K - 1) + k], x zero before 0.

    Written as K shifted multiply-adds in a fixed order (k = 0 .. K-1), not
    as ``F.conv1d``: cuDNN's depthwise weight gradient need not be bitwise
    repeatable, and the training step is bitwise deterministic on the card.
    """
    k = w.shape[0]
    length = x.shape[1]
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    wf = w.to(torch.float32)
    out = xp[:, 0:length] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + length] * wf[i]
    return out.to(x.dtype)


def conv1d_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """One decode step of the causal conv. conv_state: (B, K-1, C), the
    previous K-1 inputs; x_t: (B, C). Returns (new_state, y_t): NEW tensors,
    the state given is not written (a retried step reads it again), and y_t
    the same f32 multiply-adds in the same order as ``causal_conv1d``."""
    window = torch.cat([conv_state, x_t[:, None, :]], 1)          # (B, K, C)
    wf = w.to(torch.float32)
    y = window[:, 0].to(torch.float32) * wf[0]
    for i in range(1, w.shape[0]):
        y = y + window[:, i].to(torch.float32) * wf[i]
    return window[:, 1:], y.to(x_t.dtype)


def gather_outputs(y: torch.Tensor, sv) -> torch.Tensor:
    """A serving rank's outputs of its heads or channels (the last dim)
    gathered over ``sv``'s axis in rank order where the weights after
    them are whole (``models.parallel.Serve.gather_heads``)."""
    return sv.gather(y, -1) if sv is not None and sv.gather_heads else y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rot_dim: int | None = None) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions broadcastable to
    (..., S). ``rot_dim`` (default D): only the first ``rot_dim`` channels
    rotate, the rest pass through. Computed in f32, returned in x's
    dtype."""
    rot = rot_dim or x.shape[-1]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], -1).to(x.dtype)
