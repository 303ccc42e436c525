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
make_mesh_guarded_train_step: the data-parallel guarded step of the
reference's ``--mesh`` (``shard_map`` there, one process per rank here):
each rank's gradients on its rows of the global batch, summed across ranks
by the fixed-order combine, so the guarded update runs on bitwise the same
inputs on every rank.
"""

from __future__ import annotations

import time

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


def _rows_of(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s equal share of ``x``'s leading axis."""
    if x.shape[0] % world:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {world} ranks")
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def make_mesh_guarded_train_step(cfg, tcfg, mesh, reduce_backend=None, spike_z: float = 6.0):
    """The data-parallel guarded step over a 1-D data mesh
    (``launch.mesh.make_data_mesh``): ``guarded_step(params, opt_state,
    guard_state, batch) -> (params, opt_state, guard_state, metrics)`` with
    the signature of ``make_guarded_train_step``'s. Parameters, moments and
    guard state are replicated: every rank holds them whole and updates
    them in place. Every rank is given the GLOBAL batch (its leading axis
    must divide by the mesh) and
      computes the gradients of its own rows (``make_grads_fn``);
      multiplies them by its entry of ``batch["chaos_scale"]`` (shape
        (world,), where given: driving one entry to NaN models one host's
        shard going bad);
      sums the gradients and the loss across ranks by
        ``core.collectives.fixed_order_combine`` and divides by the world
        size: bitwise the same on every rank, unlike an all-reduce, whose
        order is the transport's;
      runs ``optim.guarded_apply_updates`` on those inputs, so the census,
        the skip, the write-back and the guard state move in lockstep,
        even when one rank's shard is poisoned.
    As in the reference, the clip statistic then runs locally over the
    combined gradients (one K4 launch a rank on cuda_fused).

    ``metrics`` adds ``combine_s`` (host seconds of the exchange, the card
    synchronised on both sides) and ``combine_bytes`` (bytes it brings
    into this rank, modelled: ``core.cost_model.interconnect_bytes`` of the
    gathered elements; ``reduce.inspect.collective_recv_bytes`` around the
    step meters the same, as ``tests/test_torch_data_mesh.py`` and
    ``chip_smoke.py`` check)."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.cost_model import interconnect_bytes

    if reduce_backend is None:
        reduce_backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    (axis,) = mesh.axis_names
    rank, world = mesh.axis_index(axis), mesh.axis_size(axis)
    compute_grads = make_grads_fn(cfg, tcfg)

    def sync(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def guarded_step(params, opt_state, guard_state, batch):
        batch = dict(batch)
        scale = batch.pop("chaos_scale", None)
        grads, loss = compute_grads(params, {k: _rows_of(v, rank, world)
                                             for k, v in batch.items()})
        if scale is not None:
            s = scale.reshape(-1)[rank]
            for g in grads:
                g.mul_(s.to(g.dtype))
        sync(loss.device)
        t0 = time.perf_counter()
        with coll.bound_mesh(mesh):
            for i, g in enumerate(grads):
                # the combined sum replaces the local gradient (freed here)
                grads[i] = coll.fixed_order_combine(g, (axis,)).div_(world)
            loss = coll.fixed_order_combine(loss.reshape(1), (axis,))[0] / world
        sync(loss.device)
        combine_s = time.perf_counter() - t0
        params, opt_state, guard_state, metrics = optim.guarded_apply_updates(
            params, grads, opt_state, tcfg, loss=loss, guard=guard_state,
            spike_z=spike_z, reduce_backend=reduce_backend,
            fused_second_moment=tcfg.fused_second_moment,
            leaf_groups=reference_leaf_groups(params, cfg),
        )
        n = sum(g.numel() for g in grads) + 1
        return params, opt_state, guard_state, dict(
            metrics, loss=loss, combine_s=combine_s,
            combine_bytes=interconnect_bytes(n, world).recv_per_device)

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
