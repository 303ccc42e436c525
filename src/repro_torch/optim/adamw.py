"""AdamW with decoupled weight decay, a cosine schedule and the one-launch
clipping statistic.

Port of ``repro/optim/adamw.py`` (``AdamWState``, ``init_state``,
``cosine_lr``, ``global_norm``, ``global_norm_and_clip``, ``_adamw_core``,
``apply_updates``, and the guarded step: ``GuardState``,
``init_guard_state``, the loss-spike test, ``guarded_apply_updates``). The
clipping statistic -- the largest full reduction of a training step -- is
ONE ``reduce_tree(kind="norm2")`` with the epilogue fork ``[(),
("clip_coeff", max_norm, GNORM_EPS)]``: on cuda_fused one launch of the
parts kernel (K4) squares every gradient leaf, folds, takes the sqrt and
the clip coefficient, and (with the fused second moment) returns the
per-leaf sums of squares from the same launch.

State is kept as flat lists in ``reduce.tree_leaves`` order (the reference
keeps pytrees); the update writes parameters and moments IN PLACE (the
reference returns new arrays), which keeps one copy of the 1.2 B-parameter
state on the card.

``fused_second_moment`` (olmax-style) keeps ONE scalar second-moment EMA
per REFERENCE leaf (``models.convert.reference_leaf_groups``: the port
keeps one leaf per layer, the reference one per stacked unit position), fed
by the per-leaf sumsq slots of the norm launch.

``guarded_apply_updates`` adds the in-launch NaN/Inf census to the same
single launch (``census=True``: on cuda_fused K4 counts the elements it
already streams) and a skip decided ON THE DEVICE: no host value is read.
The in-place update cannot simply run and be undone, so the guarded step
computes each leaf's candidate parameter and moments into temporaries (the
same operations as ``apply_updates``, in the same order) and writes them
back through a select on integer views: a skipped step leaves parameters,
moments and ``step`` bitwise as they were (NaN payloads, -0.0, bf16 bits),
an accepted one writes exactly what ``apply_updates`` writes. Working one
leaf at a time bounds the extra memory at the largest leaf's three
temporaries. Nothing is written before that final select, so a step that
raises before it (an injected transient fault) leaves the state clean for
its retry.
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


def global_norm(grads, *, mma: bool = True, backend: Optional[str] = None, mesh_axes=None):
    """L2 norm over the gradient tree via the reduction engine (one parts
    launch on cuda_fused). ``mesh_axes`` (axis names of the bound mesh)
    makes it the norm of the tree sharded across ranks, through the
    fixed-order combine: bitwise the same on every rank."""
    if backend is None:
        backend = R.backend_for_flags(mma)
    return R.reduce_tree(grads, kind="norm2", backend=backend, mesh_axes=mesh_axes)


def global_norm_and_clip(grads, max_norm, *, mma: bool = True, backend: Optional[str] = None,
                         return_per_leaf: bool = False, census: bool = False, mesh_axes=None):
    """``(gnorm, clip)`` from ONE reduction launch (the epilogue fork
    finishes the norm's sqrt and ``min(1, max_norm / max(gnorm,
    GNORM_EPS))`` in it). ``return_per_leaf=True`` first returns the raw
    per-leaf sums of squares of the same launch. ``census=True`` appends
    the (S + 1,) NaN/Inf counts (per leaf, then their total), counted by
    the same launch on the elements it already streams: the guarded step's
    detector at no extra input bytes. ``mesh_axes`` (over gradients sharded
    across ranks) makes the norm, the clip, the per-leaf sums and the
    census global through the fixed-order combine: every rank sees the
    same bits, so a skip decided from them is the same on every rank."""
    if backend is None:
        backend = R.backend_for_flags(mma)
    fork = [(), ("clip_coeff", float(max_norm), GNORM_EPS)]
    out = R.reduce_tree(grads, kind="norm2", backend=backend, epilogue=fork,
                        return_per_leaf=return_per_leaf, census=census, mesh_axes=mesh_axes)
    if return_per_leaf:
        if census:
            per_leaf, fork_out, counts = out
            return per_leaf, fork_out[0], fork_out[1], counts
        per_leaf, fork_out = out
        return per_leaf, fork_out[0], fork_out[1]
    if census:
        fork_out, counts = out
        return fork_out[0], fork_out[1], counts
    return out[0], out[1]


# Signed integer views for the bitwise keep/advance select, by element size
# (the reference's unsigned ``_BLEND_UINT``; a select moves bits either way).
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bitwise_keep(keep_old, old, new):
    """``old`` where ``keep_old`` (a bool scalar tensor) else ``new``, by a
    select on integer views: the kept side is BITWISE its input (NaN
    payloads, -0.0, bf16 bits)."""
    it = _INT_VIEW[old.element_size()]
    return torch.where(keep_old, old.view(it), new.view(it)).view(old.dtype)


def _keep_into(keep_old, dst, new) -> None:
    """``dst`` keeps its bits where ``keep_old``, else takes ``new``'s; in
    place."""
    it = _INT_VIEW[dst.element_size()]
    d = dst.view(it)
    torch.where(keep_old, d, new.view(it), out=d)


@torch.no_grad()
def _adamw_core(params: list, grads: list, state: AdamWState, cfg, *, clip, per_leaf=None,
                fused_second_moment: bool = False, leaf_groups=None, keep=None):
    """The AdamW arithmetic given the clip coefficient (and, for the fused
    second moment, the per-leaf sumsq slots), in the reference's operation
    order; parameters and moments update in place. Returns (state, lr).

    ``keep`` (a bool scalar tensor, the guarded step's skip) computes each
    leaf's candidate into temporaries by the same operations and writes it
    back through ``_keep_into``: where ``keep`` is true nothing changes,
    bitwise; where false the result is bitwise the unguarded update.

    Each leaf's update runs in a function of its own, so its temporaries
    are freed before the next leaf's are made: the step's peak holds those
    of one leaf (``launch.train.ADAMW_LEAF_TEMPS``)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1**stepf
    bc2 = 1 - b2**stepf
    if keep is not None:
        step = _bitwise_keep(keep, state.step, step)

    def moment(t, beta, inc):
        # beta * t + inc: in place, or into a fresh candidate when guarded
        out = t.mul_(beta) if keep is None else t.mul(beta)
        return out.add_(inc)

    def write(p, m, m_new, pf_new, v=None, v_new=None):
        if keep is None:
            p.copy_(pf_new)
            return
        _keep_into(keep, p, pf_new.to(p.dtype))
        _keep_into(keep, m, m_new)
        if v is not None:
            _keep_into(keep, v, v_new)

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
        def fused_leaf(p, g, m, k):
            gf = g.to(torch.float32) * clip
            m_new = moment(m, b1, (1 - b1) * gf)
            pf = p.to(torch.float32)
            write(p, m, m_new, pf - (lr * rcp[k] / bc1) * m_new - (lr * cfg.weight_decay) * pf)

        for p, g, m, k in zip(params, grads, state.m, groups):
            fused_leaf(p, g, m, k)
        if keep is not None:
            v = [_bitwise_keep(keep, old, new) for old, new in zip(state.v, v)]
        return AdamWState(step=step, m=state.m, v=v), lr
    def leaf(p, g, m, v):
        gf = g.to(torch.float32) * clip
        m_new = moment(m, b1, (1 - b1) * gf)
        v_new = moment(v, b2, (1 - b2) * gf * gf)
        mhat = m_new / bc1
        vhat = v_new / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + ADAM_EPS) + cfg.weight_decay * pf
        write(p, m, m_new, pf - lr * delta, v, v_new)

    for p, g, m, v in zip(params, grads, state.m, state.v):
        leaf(p, g, m, v)
    return AdamWState(step=step, m=state.m, v=state.v), lr


def apply_updates(params, grads, state: AdamWState, cfg, *, mma: bool = True,
                  reduce_backend: Optional[str] = None, fused_second_moment: bool = False,
                  leaf_groups: Optional[Sequence[int]] = None, mesh_axes=None):
    """One AdamW step on the parameter tree (updated in place). ``grads``
    is a tree like ``params`` or the flat list of its leaves. Returns
    (params, new_state, metrics). ``mesh_axes``: parameters, gradients and
    moments are this rank's shards of trees sharded across those axes; the
    clip statistic is the global one (``global_norm_and_clip``)."""
    flat_p = R.tree_leaves(params)
    flat_g = R.tree_leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} parameters")
    if fused_second_moment:
        per_leaf, gnorm, clip = global_norm_and_clip(
            flat_g, cfg.grad_clip, mma=mma, backend=reduce_backend, return_per_leaf=True,
            mesh_axes=mesh_axes)
    else:
        per_leaf = None
        gnorm, clip = global_norm_and_clip(flat_g, cfg.grad_clip, mma=mma,
                                           backend=reduce_backend, mesh_axes=mesh_axes)
    new_state, lr = _adamw_core(flat_p, flat_g, state, cfg, clip=clip, per_leaf=per_leaf,
                                fused_second_moment=fused_second_moment,
                                leaf_groups=leaf_groups)
    return params, new_state, {"grad_norm": gnorm, "lr": lr, "clip": clip}


@dataclasses.dataclass
class GuardState:
    """Loss-spike detector state: a rolling window of the last W ACCEPTED
    (non-skipped, finite) losses, how many of its slots are valid, and the
    cumulative skipped-step count; tensors on the training device."""

    window: Any   # (W,) f32 recent accepted losses
    filled: Any   # int32 valid slots (spike detection waits for a full W)
    skipped: Any  # int32 cumulative skipped steps


def init_guard_state(window: int = 16, device=None) -> GuardState:
    return GuardState(
        window=torch.zeros((int(window),), dtype=torch.float32, device=device),
        filled=torch.zeros((), dtype=torch.int32, device=device),
        skipped=torch.zeros((), dtype=torch.int32, device=device),
    )


def _sorted_median(v):
    """Median by one sort and two static slots (the reference's form)."""
    s = torch.sort(v).values
    w = v.shape[0]
    return 0.5 * (s[(w - 1) // 2] + s[w // 2])


def _finite_scalar(x):
    """Finite iff x - x == 0 (NaN - NaN and Inf - Inf are NaN)."""
    return (x - x) == 0


def _loss_spike(guard: GuardState, loss, spike_z: float):
    """Robust z-score spike test against the accepted-loss window: spike
    iff the window is full, the loss is finite (a NON-finite loss is the
    census's business) and ``loss - median > spike_z * scale`` with the
    MAD-based ``scale = 1.4826 * mad + 1e-6 * |median| + 1e-12`` (the
    relative floor keeps a flat window from flagging float noise)."""
    w = guard.window.shape[0]
    med = _sorted_median(guard.window)
    mad = _sorted_median(torch.abs(guard.window - med))
    scale = 1.4826 * mad + 1e-6 * torch.abs(med) + 1e-12
    full = guard.filled >= w
    return full & _finite_scalar(loss) & ((loss - med) > spike_z * scale)


def guarded_apply_updates(params, grads, state: AdamWState, cfg, *, loss=None,
                          guard: Optional[GuardState] = None, spike_z: float = 6.0,
                          mma: bool = True, reduce_backend: Optional[str] = None,
                          fused_second_moment: bool = False,
                          leaf_groups: Optional[Sequence[int]] = None, mesh_axes=None):
    """One GUARDED AdamW step: the single-launch clip statistic of
    ``apply_updates`` with the in-launch NaN/Inf census, and a skip decided
    on the device: if any gradient element is NaN/Inf (or the windowed
    loss-spike test fires) the parameters and the optimizer state pass
    through BITWISE unchanged. Returns ``(params, new_state, new_guard,
    metrics)``; parameters and moments update in place (see the module
    doc). An accepted step is bitwise ``apply_updates``.

    ``loss``/``guard`` feed the spike test (either None disables it): the
    window records ACCEPTED finite losses only. ``metrics['skipped']`` is
    this step's skip flag (0/1 f32), ``metrics['nonfinite']`` the census
    total.

    ``mesh_axes`` (parameters, gradients and moments sharded across those
    axes of the bound mesh): the statistic, the census and the clip come
    out of the fixed-order combine bitwise the same on every rank, so the
    skip, the write-back and the guard state move in lockstep while each
    rank updates only its shards. ``loss`` must already be the same on
    every rank for the spike test to agree."""
    flat_p = R.tree_leaves(params)
    flat_g = R.tree_leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} parameters")
    if fused_second_moment:
        per_leaf, gnorm, clip, counts = global_norm_and_clip(
            flat_g, cfg.grad_clip, mma=mma, backend=reduce_backend, return_per_leaf=True,
            census=True, mesh_axes=mesh_axes)
    else:
        per_leaf = None
        gnorm, clip, counts = global_norm_and_clip(
            flat_g, cfg.grad_clip, mma=mma, backend=reduce_backend, census=True,
            mesh_axes=mesh_axes)
    nonfinite = counts[-1]
    bad = nonfinite > 0
    loss_f = None if loss is None else torch.as_tensor(loss, dtype=torch.float32,
                                                       device=bad.device)
    if loss_f is not None and guard is not None:
        spike = _loss_spike(guard, loss_f, spike_z)
    else:
        spike = torch.zeros((), dtype=torch.bool, device=bad.device)
    skip = bad | spike
    new_state, lr = _adamw_core(flat_p, flat_g, state, cfg, clip=clip, per_leaf=per_leaf,
                                fused_second_moment=fused_second_moment,
                                leaf_groups=leaf_groups, keep=skip)
    new_guard = guard
    if guard is not None:
        w = guard.window.shape[0]
        if loss_f is not None:
            record = ~skip & _finite_scalar(loss_f)
            rolled = torch.cat([guard.window[1:], loss_f.reshape(1)])
            window = _bitwise_keep(~record, guard.window, rolled)
        else:
            record = torch.zeros((), dtype=torch.bool, device=bad.device)
            window = guard.window
        new_guard = GuardState(
            window=window,
            filled=torch.clamp_max(guard.filled + record.to(torch.int32), w),
            skipped=guard.skipped + skip.to(torch.int32),
        )
    metrics = {"grad_norm": gnorm, "lr": lr, "clip": clip, "nonfinite": nonfinite,
               "skipped": skip.to(torch.float32), "spike": spike.to(torch.float32)}
    return params, new_state, new_guard, metrics
