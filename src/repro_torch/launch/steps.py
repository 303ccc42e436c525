"""Training and serving steps.

Port of ``make_train_step``, ``make_guarded_train_step``,
``make_prefill_step`` and ``make_decode_step`` of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a plain
closure over the config (the reference jits it).

make_train_step: a Python loop over microbatches (the reference's
``lax.scan``), f32 gradient accumulators, the remat'd forward and chunked
loss, and the AdamW update whose clip statistic is one reduction launch.
make_guarded_train_step: the same gradients (``make_grads_fn``), finished
by ``optim.guarded_apply_updates``: the same launch also counts NaN/Inf
gradient elements, and a poisoned or loss-spiking step passes the
parameters and the optimizer state through bitwise unchanged.
"""

from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.models import decode_step as model_decode
from repro_torch.models import make_caches, prefill
from repro_torch.models.convert import reference_leaf_groups
from repro_torch.models.losses import lm_loss_chunked
from repro_torch.models.model import forward_hidden


def _split_batch(tokens: torch.Tensor, n_micro: int) -> torch.Tensor:
    gb = tokens.shape[0]
    if gb % n_micro:
        raise ValueError(f"batch {gb} does not split into {n_micro} microbatches")
    return tokens.reshape((n_micro, gb // n_micro) + tuple(tokens.shape[1:]))


def make_grads_fn(cfg, tcfg):
    """``compute_grads(params, batch) -> (grads, mean_loss)``: per
    microbatch the loss and its gradients, accumulated in f32 and averaged
    over the microbatches in place (``grads`` are the flat leaves in
    ``reduce.tree_leaves`` order; ``launch.train.train_step_peak_bytes``
    charges them). ``batch["image_embeds"]``, where given,
    is the cross-attention context, split with the tokens."""

    def loss_fn(params, tokens, ctx):
        h, aux = forward_hidden(params, cfg, tokens[:, :-1], ctx)
        labels = tokens[:, 1:]  # (B, S - 1), or (B, S - 1, K) with codebooks
        loss, _ = lm_loss_chunked(params, cfg, h, labels, aux)
        return loss

    def compute_grads(params, batch):
        leaves = R.tree_leaves(params)
        n_micro = tcfg.microbatches
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        lacc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        mtoks = _split_batch(batch["tokens"], n_micro)
        ctx = batch.get("image_embeds")
        mctx = [None] * n_micro if ctx is None else _split_batch(ctx, n_micro)
        for mb, cx in zip(mtoks, mctx):
            loss = loss_fn(params, mb.to(torch.int64), cx)
            grads = torch.autograd.grad(loss, leaves)
            for a, g in zip(gacc, grads):
                a.add_(g)  # f32 += g: bitwise a + g.to(f32), with no f32 copy of g
            del grads  # one microbatch's gradients alive at a time, as the fit check charges
            lacc = lacc + loss.detach()
        for a in gacc:
            a.div_(n_micro)  # in place: bitwise a / n_micro, with no second f32 copy
        return gacc, lacc / n_micro

    return compute_grads


def make_train_step(cfg, tcfg):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch = {"tokens": (GB, S + 1) int}`` ((GB, S + 1, K) for
    an arch with K codebook streams; and
    ``"image_embeds"``, (GB, N, d), for a cross-attention arch). Parameters must
    require grad; they and the optimizer state update in place. The clip
    statistic runs on the config flags' backend (``cuda_fused`` with the
    kernels on; the launchers' ``--reduce-backend`` overrides it)."""
    reduce_backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    compute_grads = make_grads_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        grads, mean_loss = compute_grads(params, batch)
        params, opt_state, metrics = optim.apply_updates(
            params, grads, opt_state, tcfg, reduce_backend=reduce_backend,
            fused_second_moment=tcfg.fused_second_moment,
            leaf_groups=reference_leaf_groups(params, cfg),
        )
        return params, opt_state, dict(metrics, loss=mean_loss)

    return train_step


def make_guarded_train_step(cfg, tcfg, reduce_backend=None, spike_z: float = 6.0):
    """Returns ``guarded_step(params, opt_state, guard_state, batch) ->
    (params, opt_state, guard_state, metrics)``; ``guard_state`` is
    ``optim.init_guard_state(W)`` on the training device. The clip
    statistic's launch also counts NaN/Inf gradient elements, and a
    poisoned or loss-spiking step passes the parameters and the optimizer
    state through BITWISE unchanged (``metrics['skipped']`` flags it for
    the rollback counter); an accepted step is bitwise ``make_train_step``'s
    on the same batch. ``batch`` may carry ``"chaos_scale"``, a (1,)
    tensor the gradients are multiplied by: the fault drills drive it to
    NaN or Inf on a scheduled step, and x1.0 is bitwise identity."""
    if reduce_backend is None:
        reduce_backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    compute_grads = make_grads_fn(cfg, tcfg)

    def guarded_step(params, opt_state, guard_state, batch):
        batch = dict(batch)
        scale = batch.pop("chaos_scale", None)
        grads, mean_loss = compute_grads(params, batch)
        if scale is not None:
            s = scale.reshape(-1)[0]
            for g in grads:
                g.mul_(s.to(g.dtype))
        params, opt_state, guard_state, metrics = optim.guarded_apply_updates(
            params, grads, opt_state, tcfg, loss=mean_loss, guard=guard_state,
            spike_z=spike_z, reduce_backend=reduce_backend,
            fused_second_moment=tcfg.fused_second_moment,
            leaf_groups=reference_leaf_groups(params, cfg),
        )
        return params, opt_state, guard_state, dict(metrics, loss=mean_loss)

    return guarded_step


def make_prefill_step(cfg, s_max: int):
    def prefill_step(params, tokens: torch.Tensor, ctx=None):
        caches = make_caches(cfg, tokens.shape[0], s_max, tokens.device)
        return prefill(params, cfg, tokens, caches, ctx)

    return prefill_step


def make_decode_step(cfg, greedy: bool = True):
    def decode_one(params, caches, token: torch.Tensor, pos: int, ctx=None):
        logits, caches = model_decode(params, cfg, token, caches, pos, ctx)
        if greedy:
            return torch.argmax(logits, -1).to(torch.int32), caches
        return logits, caches

    return decode_one
