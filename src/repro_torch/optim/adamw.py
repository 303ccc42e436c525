"""AdamW with decoupled weight decay, a cosine schedule and the one-launch
clipping statistic.

Port of ``repro/optim/adamw.py`` (``AdamWState``, ``init_state``,
``cosine_lr``, ``global_norm``, ``global_norm_and_clip``, ``_adamw_core``,
``apply_updates``). The clipping statistic -- the largest full reduction
of a training step -- is ONE ``reduce_tree(kind="norm2")`` with the
epilogue fork ``[(), ("clip_coeff", max_norm, GNORM_EPS)]``: on cuda_fused
one launch of the parts kernel (K4) squares every gradient leaf, folds,
takes the sqrt and the clip coefficient, and (with the fused second
moment) returns the per-leaf sums of squares from the same launch.

State is kept as flat lists in ``reduce.tree_leaves`` order (the reference
keeps pytrees); the update writes parameters and moments IN PLACE (the
reference returns new arrays), which keeps one copy of the 1.2 B-parameter
state on the card.

``fused_second_moment`` (olmax-style) keeps ONE scalar second-moment EMA
per REFERENCE leaf (``models.convert.reference_leaf_groups``: the port
keeps one leaf per layer, the reference one per stacked unit position), fed
by the per-leaf sumsq slots of the norm launch.

``guarded_apply_updates`` and the guard state are not ported yet (guarded
training).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch import reduce as R

# Gradient-norm floor of the clip coefficient: clip = min(1, c / max(g, EPS)).
GNORM_EPS = 1e-9
# Adam denominator fuzz.
ADAM_EPS = 1e-8


@dataclasses.dataclass
class AdamWState:
    step: Any          # int32 scalar tensor
    m: list            # f32 first moments, one per leaf
    v: list            # f32 second moments per leaf, or one scalar per group


def _groups(n_leaves: int, leaf_groups: Optional[Sequence[int]]) -> tuple:
    if leaf_groups is None:
        return tuple(range(n_leaves))
    if len(leaf_groups) != n_leaves:
        raise ValueError(f"{len(leaf_groups)} leaf groups for {n_leaves} leaves")
    return tuple(leaf_groups)


def init_state(params, *, fused_second_moment: bool = False,
               leaf_groups: Optional[Sequence[int]] = None) -> AdamWState:
    """Zero moments. ``fused_second_moment=True`` keeps one f32 scalar
    ``v`` per leaf group (per leaf when ``leaf_groups`` is None) instead of
    an elementwise tensor."""
    leaves = R.tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    if fused_second_moment:
        n_groups = max(_groups(len(leaves), leaf_groups), default=-1) + 1
        v = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(n_groups)]
    else:
        v = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=m, v=v)


def cosine_lr(cfg, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay, in f32 as the reference computes it."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    return cfg.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def global_norm(grads, *, mma: bool = True, backend: Optional[str] = None):
    """L2 norm over the gradient tree via the reduction engine (one parts
    launch on cuda_fused)."""
    if backend is None:
        backend = R.backend_for_flags(mma)
    return R.reduce_tree(grads, kind="norm2", backend=backend)


def global_norm_and_clip(grads, max_norm, *, mma: bool = True, backend: Optional[str] = None,
                         return_per_leaf: bool = False):
    """``(gnorm, clip)`` from ONE reduction launch (the epilogue fork
    finishes the norm's sqrt and ``min(1, max_norm / max(gnorm,
    GNORM_EPS))`` in it). ``return_per_leaf=True`` first returns the raw
    per-leaf sums of squares of the same launch. (The census of guarded
    training is not ported yet.)"""
    if backend is None:
        backend = R.backend_for_flags(mma)
    fork = [(), ("clip_coeff", float(max_norm), GNORM_EPS)]
    out = R.reduce_tree(grads, kind="norm2", backend=backend, epilogue=fork,
                        return_per_leaf=return_per_leaf)
    if return_per_leaf:
        per_leaf, fork_out = out
        return per_leaf, fork_out[0], fork_out[1]
    return out[0], out[1]


@torch.no_grad()
def _adamw_core(params: list, grads: list, state: AdamWState, cfg, *, clip, per_leaf=None,
                fused_second_moment: bool = False, leaf_groups=None):
    """The AdamW arithmetic given the clip coefficient (and, for the fused
    second moment, the per-leaf sumsq slots), in the reference's operation
    order; parameters and moments update in place. Returns (state, lr)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1**stepf
    bc2 = 1 - b2**stepf
    if fused_second_moment:
        groups = _groups(len(params), leaf_groups)
        v = list(state.v)
        rcp = []
        for k in range(len(v)):
            members = [i for i, gk in enumerate(groups) if gk == k]
            n = max(sum(params[i].numel() for i in members), 1)
            sumsq = per_leaf[members[0]]
            for i in members[1:]:
                sumsq = sumsq + per_leaf[i]
            # scalar EMA of E[(clip g)^2]; all moment math is size-1
            v[k] = b2 * v[k] + (1 - b2) * (clip * clip) * (sumsq / n)
            rcp.append(1.0 / (torch.sqrt(v[k] / bc2) + ADAM_EPS))
        for p, g, m, k in zip(params, grads, state.m, groups):
            gf = g.to(torch.float32) * clip
            m.mul_(b1).add_((1 - b1) * gf)
            pf = p.to(torch.float32)
            p.copy_(pf - (lr * rcp[k] / bc1) * m - (lr * cfg.weight_decay) * pf)
        return AdamWState(step=step, m=state.m, v=v), lr
    for p, g, m, v in zip(params, grads, state.m, state.v):
        gf = g.to(torch.float32) * clip
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + ADAM_EPS) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return AdamWState(step=step, m=state.m, v=state.v), lr


def apply_updates(params, grads, state: AdamWState, cfg, *, mma: bool = True,
                  reduce_backend: Optional[str] = None, fused_second_moment: bool = False,
                  leaf_groups: Optional[Sequence[int]] = None):
    """One AdamW step on the parameter tree (updated in place). ``grads``
    is a tree like ``params`` or the flat list of its leaves. Returns
    (params, new_state, metrics)."""
    flat_p = R.tree_leaves(params)
    flat_g = R.tree_leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} parameters")
    if fused_second_moment:
        per_leaf, gnorm, clip = global_norm_and_clip(
            flat_g, cfg.grad_clip, mma=mma, backend=reduce_backend, return_per_leaf=True)
    else:
        per_leaf = None
        gnorm, clip = global_norm_and_clip(flat_g, cfg.grad_clip, mma=mma,
                                           backend=reduce_backend)
    new_state, lr = _adamw_core(flat_p, flat_g, state, cfg, clip=clip, per_leaf=per_leaf,
                                fused_second_moment=fused_second_moment,
                                leaf_groups=leaf_groups)
    return params, new_state, {"grad_norm": gnorm, "lr": lr, "clip": clip}
