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

``mesh=`` and ``param_shardings=`` on ``make_train_step`` and
``make_guarded_train_step`` (as the reference has them) make the sharded
step over a mesh that splits the world, e.g. (data 2, model 2): every
parameter is a rank's block of its spec (``launch.sharding``), and the
forward and backward run FSDP, tensor and expert parallelism
(``models.parallel``). Every rank is given the GLOBAL batch and runs its
rows: each microbatch cut over the batch axes (``mesh.batch_axes``); the
model ranks of a data group hold the same rows. The f32 accumulators are per
block. After the microbatches, a leaf its spec leaves whole along a batch
axis has its gradient summed over that axis (a fixed-order combine; the
blocks cut over it came summed out of the backward's reduce-scatter), and
every gradient is divided by the microbatches times the batch ranks. The
loss is the rank-order mean over the batch axes. The clip statistic counts
each leaf once (``optim.adamw.sharded_norm_and_clip``), and AdamW updates
each rank's blocks in place. ``torch.utils.checkpoint``'s early stop is
off in the sharded forward, so each recompute runs its block's
collectives again, all of them (``launch.dryrun`` counts them so).

``mesh=`` and ``param_shardings=`` on ``make_prefill_step`` and
``make_decode_step`` make the sharded serving steps (the reference's rules
for the config, ``launch.dryrun.rules_for``, when no specs are given): the
rank's blocks of the weights and of the caches
(``launch.sharding.cache_shardings``, made by rank: ``make_rank_caches``),
its rows of the global batch, each block laid out by
``models.parallel.Plan.serve_layout`` (TP, EP, FSDP, and every block
kind's caches: k/v and cross-attention caches cut by heads or by slots --
the split-KV decode, a ring's too -- MLA's latent by slots, the SSM's
state by heads and its conv window by channels, the RG-LRU's by
channels), the logits gathered over the whole vocabulary (each codebook
stream's), and the greedy token by a (max, index) merge over "model".
With ``mesh=None`` both are the single-device steps.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

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


def make_grads_fn(cfg, tcfg, plan=None):
    """``compute_grads(params, batch) -> (grads, mean_loss)``: per
    microbatch the loss and its gradients, accumulated in f32 and averaged
    over the microbatches in place (``grads`` are the flat leaves in
    ``reduce.tree_leaves`` order; ``launch.train.train_step_peak_bytes``
    charges them). ``batch["image_embeds"]``, where given,
    is the cross-attention context, split with the tokens. ``plan``
    (``models.parallel.Plan``): ``params`` are a rank's blocks and
    ``batch`` its rows; the gradients are summed over the batch axes and
    averaged over them too, and the loss is the batch ranks' mean (module
    doc)."""

    def loss_fn(params, tokens, ctx):
        with contextlib.nullcontext() if plan is None else set_checkpoint_early_stop(False):
            h, aux = forward_hidden(params, cfg, tokens[:, :-1], ctx, plan)
            labels = tokens[:, 1:]  # (B, S - 1), or (B, S - 1, K) with codebooks
            loss, _ = lm_loss_chunked(params, cfg, h, labels, aux, plan=plan)
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
        if plan is None:
            for a in gacc:
                a.div_(n_micro)  # in place: bitwise a / n_micro, with no second f32 copy
            return gacc, lacc / n_micro
        return _finish_sharded(plan, gacc, lacc / n_micro, n_micro)

    return compute_grads


# Elements a step-end gradient combine gathers at a time (``_finish_sharded``).
COMBINE_CHUNK = 1 << 24


def _finish_sharded(plan, gacc: list, loss, n_micro: int):
    """The sharded step's gradients and loss after the microbatches (module
    doc): each leaf summed over the batch axes its spec leaves whole, all
    divided by the microbatches times the batch ranks; the loss averaged
    over the batch ranks."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch.sharding import spec_axes, tree_leaves

    specs = tree_leaves(plan.specs)
    for a, spec in zip(gacc, specs):
        whole = tuple(ax for ax in plan.batch if ax not in spec_axes(spec))
        if whole:  # in pieces, in place: the fold is elementwise
            flat = a.view(-1)
            for i in range(0, flat.numel(), COMBINE_CHUNK):
                piece = flat[i:i + COMBINE_CHUNK]
                piece.copy_(coll.fixed_order_combine(piece, whole, plan.mesh))
        a.div_(n_micro * plan.data_degree)
    loss = coll.fixed_order_combine(loss.reshape(1), plan.batch, plan.mesh)[0]
    return gacc, loss / plan.data_degree


def _sharded(cfg, mesh, param_shardings):
    """The plan of a sharded step; specs from ``param_axes`` under
    DEFAULT_RULES when none are given."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_params, param_axes
    from repro_torch.models.parallel import Plan

    if param_shardings is None:
        shapes = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
        param_shardings = SH.param_shardings(param_axes(cfg), mesh, SH.DEFAULT_RULES, shapes)
    return Plan(cfg, mesh, param_shardings)


def _plan_rows(plan, batch: dict, n_micro: int) -> dict:
    """The rank's rows of every tensor of the global batch: each of the
    ``n_micro`` microbatches (contiguous, as the single-device step cuts
    them) cut over the batch axes, row-major in them, and the rank's parts
    of the microbatches laid end to end; so microbatch j of the rank is
    its part of the single-device step's microbatch j (the MoE's
    load-balance statistic is taken over a whole microbatch)."""
    from repro_torch.launch.sharding import _degree_and_index

    deg, idx = _degree_and_index(plan.mesh, plan.batch)

    def rows(x):
        micro = _split_batch(x, n_micro)
        part = torch.stack([_rows_of(m, idx, deg) for m in micro])
        return part.reshape((-1,) + tuple(x.shape[1:]))

    return {k: rows(v) for k, v in batch.items()}


def _leaf_axes(plan) -> list:
    from repro_torch.launch.sharding import spec_axes, tree_leaves

    return [spec_axes(s) for s in tree_leaves(plan.specs)]


def _activations(plan, rows: int):
    """The activation context of the sharded forward (``models.context``):
    the rank's rows of each microbatch."""
    from repro_torch.models import context as CTX

    entry = plan.batch[0] if len(plan.batch) == 1 else (plan.batch or None)
    return CTX.activation_sharding(plan.mesh, (entry, None, None), rows)


def make_train_step(cfg, tcfg, mesh=None, param_shardings=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch = {"tokens": (GB, S + 1) int}`` ((GB, S + 1, K) for
    an arch with K codebook streams; and
    ``"image_embeds"``, (GB, N, d), for a cross-attention arch). Parameters must
    require grad; they and the optimizer state update in place. The clip
    statistic runs on the config flags' backend (``cuda_fused`` with the
    kernels on; the launchers' ``--reduce-backend`` overrides it).

    ``mesh`` (with ``param_shardings``, a spec tree like the parameters;
    DEFAULT_RULES' when None): the sharded step (module doc); parameters
    and moments are the rank's blocks, ``batch`` the global batch."""
    reduce_backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    plan = None if mesh is None else _sharded(cfg, mesh, param_shardings)
    compute_grads = make_grads_fn(cfg, tcfg, plan)
    sharded = {} if plan is None else dict(leaf_axes=_leaf_axes(plan), mesh=mesh)

    def train_step(params, opt_state, batch):
        if plan is None:
            grads, mean_loss = compute_grads(params, batch)
        else:
            batch = _plan_rows(plan, batch, tcfg.microbatches)
            with _activations(plan, batch["tokens"].shape[0] // tcfg.microbatches):
                grads, mean_loss = compute_grads(params, batch)
        params, opt_state, metrics = optim.apply_updates(
            params, grads, opt_state, tcfg, reduce_backend=reduce_backend,
            fused_second_moment=tcfg.fused_second_moment,
            leaf_groups=reference_leaf_groups(params, cfg), **sharded,
        )
        return params, opt_state, dict(metrics, loss=mean_loss)

    return train_step


def make_guarded_train_step(cfg, tcfg, reduce_backend=None, spike_z: float = 6.0, mesh=None,
                            param_shardings=None):
    """Returns ``guarded_step(params, opt_state, guard_state, batch) ->
    (params, opt_state, guard_state, metrics)``; ``guard_state`` is
    ``optim.init_guard_state(W)`` on the training device. The clip
    statistic's launch also counts NaN/Inf gradient elements, and a
    poisoned or loss-spiking step passes the parameters and the optimizer
    state through BITWISE unchanged (``metrics['skipped']`` flags it for
    the rollback counter); an accepted step is bitwise ``make_train_step``'s
    on the same batch. ``batch`` may carry ``"chaos_scale"``, a (1,)
    tensor the gradients are multiplied by: the fault drills drive it to
    NaN or Inf on a scheduled step, and x1.0 is bitwise identity.

    ``mesh``/``param_shardings``: the sharded step, as in
    ``make_train_step``; ``chaos_scale`` is then (world,), each rank's
    gradients multiplied by their entry (one poisoned rank poisons the
    census of every rank: the skip moves in lockstep)."""
    if reduce_backend is None:
        reduce_backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    plan = None if mesh is None else _sharded(cfg, mesh, param_shardings)
    compute_grads = make_grads_fn(cfg, tcfg, plan)
    sharded = {} if plan is None else dict(leaf_axes=_leaf_axes(plan), mesh=mesh)

    def guarded_step(params, opt_state, guard_state, batch):
        batch = dict(batch)
        scale = batch.pop("chaos_scale", None)
        if plan is None:
            grads, mean_loss = compute_grads(params, batch)
            s = None if scale is None else scale.reshape(-1)[0]
        else:
            batch = _plan_rows(plan, batch, tcfg.microbatches)
            with _activations(plan, batch["tokens"].shape[0] // tcfg.microbatches):
                grads, mean_loss = compute_grads(params, batch)
            s = None if scale is None else scale.reshape(-1)[mesh.rank]
        if s is not None:
            for g in grads:
                g.mul_(s.to(g.dtype))
        params, opt_state, guard_state, metrics = optim.guarded_apply_updates(
            params, grads, opt_state, tcfg, loss=mean_loss, guard=guard_state,
            spike_z=spike_z, reduce_backend=reduce_backend,
            fused_second_moment=tcfg.fused_second_moment,
            leaf_groups=reference_leaf_groups(params, cfg), **sharded,
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


def _serving(cfg, mesh, param_shardings):
    """``plan_for(batch, s_max)``: the plan of a sharded serving step for a
    global batch of ``batch`` rows and caches of ``s_max`` slots (memoized)
    and the caches' meta tensors. Specs from ``param_axes`` under the rules
    the reference picks (``launch.dryrun.rules_for``) when none are given;
    the caches' from ``cache_shardings`` (``Plan.for_caches``). The cuts
    ``Plan`` refuses raise here, before any call."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_params, param_axes
    from repro_torch.models.parallel import Plan

    if param_shardings is None:
        shapes = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
        rules = getattr(SH, dryrun.rules_for(cfg, "serve"))
        param_shardings = SH.param_shardings(param_axes(cfg), mesh, rules, shapes)
    plan = Plan(cfg, mesh, param_shardings)
    memo: dict = {}

    def plan_for(batch: int, s_max: int):
        if (batch, s_max) not in memo:
            meta = make_caches(cfg, batch, s_max, torch.device("meta"))
            memo[(batch, s_max)] = (plan.for_caches(meta), meta)
        return memo[(batch, s_max)]

    return plan_for


def _slots_of(caches: dict) -> int:
    """The caches' length as the decode step finds it: the most slots of a
    layer's (whole) slot positions; a ring's own where every slotted layer
    is a ring (the same caches); 1 where no layer has slots (recurrent
    states and cross-attention caches alone)."""
    return max((c["slot_pos"].shape[0] for c in caches["layers"] if "slot_pos" in c), default=1)


def make_rank_caches(plan, meta, device) -> dict:
    """The rank's blocks of the caches ``meta`` (meta tensors of the global
    shapes) under ``plan.cache_specs``: zeros, and -1 in the slot positions
    (whole on every rank)."""
    from repro_torch.launch.sharding import local_shape

    def block(t, spec, fill):
        return torch.full(local_shape(t.shape, spec, plan.mesh), fill, dtype=t.dtype,
                          device=device)

    return {"layers": [{k: block(t, cs[k], -1 if k == "slot_pos" else 0) for k, t in c.items()}
                       for c, cs in zip(meta["layers"], plan.cache_specs["layers"])]}


def make_prefill_step(cfg, s_max: int, mesh=None, param_shardings=None):
    """``prefill_step(params, tokens, ctx=None) -> (last-token logits,
    caches)``: new caches of ``s_max`` slots, filled by the prompt.

    ``mesh`` (with ``param_shardings``, a spec tree like the parameters;
    the reference's rules for the config when None): the sharded prefill
    (``models.parallel``'s module doc). ``params`` are the rank's blocks
    and ``tokens`` (and a cross-attention arch's ``ctx``) the GLOBAL batch;
    the rank runs its rows (``Plan.rows``) and returns their logits over
    the whole vocabulary and its blocks of the caches
    (``launch.sharding.cache_shardings``). The cuts ``Plan`` refuses raise
    ``NotImplementedError``."""
    if mesh is None:
        def prefill_step(params, tokens: torch.Tensor, ctx=None):
            caches = make_caches(cfg, tokens.shape[0], s_max, tokens.device)
            return prefill(params, cfg, tokens, caches, ctx)

        return prefill_step
    plan_for = _serving(cfg, mesh, param_shardings)

    def sharded_prefill_step(params, tokens: torch.Tensor, ctx=None):
        plan, meta = plan_for(tokens.shape[0], s_max)
        caches = make_rank_caches(plan, meta, tokens.device)
        with torch.no_grad():
            ctx = None if ctx is None else plan.rows(ctx)
            logits, caches = prefill(params, cfg, plan.rows(tokens), caches, ctx, plan)
            return plan.gather_logits(logits)[..., :cfg.vocab_size], caches

    return sharded_prefill_step


def make_decode_step(cfg, greedy: bool = True, mesh=None, param_shardings=None):
    """``decode_one(params, caches, token, pos, ctx=None) -> (next token
    (B, 1) int32, or the logits with ``greedy=False``, caches)``.

    ``mesh``/``param_shardings``: the sharded decode (``make_prefill_step``'s);
    ``caches`` the rank's blocks from the sharded prefill, ``token`` the
    GLOBAL batch's (B, 1), as the prefill's tokens. The greedy token is the
    (max, index) merge over "model" (``Plan.greedy``), the logits the whole
    vocabulary's; both of the rank's rows."""
    if mesh is None:
        def decode_one(params, caches, token: torch.Tensor, pos: int, ctx=None):
            logits, caches = model_decode(params, cfg, token, caches, pos, ctx)
            if greedy:
                return torch.argmax(logits, -1).to(torch.int32), caches
            return logits, caches

        return decode_one
    plan_for = _serving(cfg, mesh, param_shardings)

    def sharded_decode_one(params, caches, token: torch.Tensor, pos: int, ctx=None):
        plan, _ = plan_for(token.shape[0], _slots_of(caches))
        with torch.no_grad():
            logits, caches = model_decode(params, cfg, plan.rows(token), caches, pos, ctx, plan)
            if greedy:
                return plan.greedy(logits), caches
            return plan.gather_logits(logits)[..., :cfg.vocab_size], caches

    return sharded_decode_one
