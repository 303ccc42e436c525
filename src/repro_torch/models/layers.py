"""Shared layers: norms, FFNs, RoPE.

Port of ``repro/models/layers.py`` (``norm_apply``, ``ffn_apply``,
``rope``). The norms run the fused kernels of ``kernels.row_moments`` (the
reference's ``use_pallas`` route); the non-kernel route is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.models import params as P


def norm_apply(kind: str, p: dict, x: torch.Tensor, *, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return K.rmsnorm(x, p["scale"], eps)
    if kind == "layernorm_np":
        return K.layernorm_np(x, eps)
    raise ValueError(f"norm {kind!r} is not ported")


def ffn_init(gen, d: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind == "swiglu":
        return {
            "gate": P.dense_init(gen, d, d_ff, dtype, device),
            "up": P.dense_init(gen, d, d_ff, dtype, device),
            "down": P.dense_init(gen, d_ff, d, dtype, device),
        }
    raise ValueError(f"ffn {kind!r} is not ported; only 'swiglu' is")


def ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down(silu(x @ gate) * (x @ up))."""
    h = F.silu(P.dense_apply(p["gate"], x)) * P.dense_apply(p["up"], x)
    return P.dense_apply(p["down"], h)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions broadcastable to
    (..., S). Computed in f32, returned in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)
