"""Training CLI: config -> seeded synthetic data -> train step ->
checkpointed, optionally guarded loop.

Port of ``repro/launch/train.py``. Runs on the GPU unless given
``--device cpu``; with no GPU and no ``--device`` it raises. Parameters are
random from ``TrainConfig.seed``; the data is the seeded ``SyntheticLM``
stream, identical to the reference's for the same seed.

  python -m repro_torch.launch.train --arch olmo-1b --reduce-backend cuda_fused \\
      --steps 3 --batch 4 --seq 512
  python -m repro_torch.launch.train --arch olmo-1b --tiny --guard --chaos 0.5 \\
      --chaos-seed 0 --ckpt-dir /tmp/ckpt --steps 12 --device cpu

Flags beyond the model and schedule:
  --ckpt-dir, --ckpt-every   atomic checkpoints (``checkpoint.CheckpointManager``)
                             every N steps; a run resumes from the newest
                             commit, with the data rewound to its step
  --guard                    the guarded step: the clip statistic's launch
                             also counts NaN/Inf gradient elements, and a
                             poisoned or loss-spiking step passes parameters
                             and optimizer state through bitwise unchanged;
                             --max-bad-steps consecutive skips roll back to
                             the last commit (the anchor commit at step 0
                             when nothing newer exists)
  --spike-window, --spike-z  the loss-spike test's window and robust z-score
  --max-bad-steps            consecutive skips before a rollback
  --chaos, --chaos-seed      the fault drill (needs --guard): per step, a
                             NaN-poisoned gradient or a transient failure
                             (retried), each with half the given probability
  --status-path              the guard metrics' JSON status file, rewritten
                             at every commit (default
                             <ckpt-dir>/guard_status.json)
  --mesh                     the data-parallel guarded step over every rank
                             (needs --guard; --batch must divide by the
                             world): ``make_mesh_guarded_train_step``
                             (``launch.steps``), whose fixed-order gradient
                             combine keeps the skip and rollback decisions
                             bitwise the same on every rank. Start the ranks with
                             torchrun; each reads the global batch and
                             takes its rows; rank 0 alone writes
                             checkpoints, behind a barrier, and every rank
                             restores, so rollbacks stay in lockstep
  --chaos-host               with --mesh, the rank whose gradients the NaN
                             drill poisons (``ChaosMonkey.corrupt_shard``)

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
      --tiny --guard --mesh --chaos 0.5 --chaos-host 1 --device cpu

Refused: a config whose training step and an activation reserve do not
fit one card (``check_fits_card``, on
``train_step_peak_bytes``: deepseek-7b's 152 GB, minicpm3-4b's 93.8 GB at
full depth, recurrentgemma-9b and llama-3.2-vision-11b at full depth,
against the H100's 80 GB), which trains only when the ROADMAP's sharding
item (FSDP/TP and expert parallelism) shards it: a data mesh replicates
the state, so it makes no config fit. Under ``--mesh`` the check charges
every rank that shares the card.
mamba2-780m (17.2 GB) and musicgen-medium (30.5 GB) train at full depth;
minicpm3-4b, recurrentgemma-9b and llama-3.2-vision-11b at full width cut
in depth, through
``main(cfg=...)``: recurrentgemma in whole units of 3 layers, 6 layers
unguarded (75.3 GB; 9 refused) and 3 with ``--guard`` (75.4 GB; 6
refused), its peak set by AdamW's f32 temporaries of the 1.05 B-element
embedding and head; llama-3.2-vision at 10 layers (60.0 / 64.2 GB). A
cross-attention arch trains against one synthetic image context, (batch,
n_img_tokens, d_model) from a generator seeded 1, in every batch, as the
reference's CLI does; an audio arch reads (batch, seq + 1, n_codebooks)
tokens from the same stream.
The unguarded loop reads its batches through a ``Prefetcher``; the guarded
loop reads the source directly, because a rollback rewinds it.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import Prefetcher, ShardInfo, SyntheticLM
from repro_torch.kernels.mma_reduce import PARTS_KERNEL_MAX
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (
    make_guarded_train_step,
    make_mesh_guarded_train_step,
    make_train_step,
)
from repro_torch.models import init_params
from repro_torch.models import model as model_lib
from repro_torch.models.convert import reference_leaf_groups
from repro_torch.models.frontends import synth_image_embeds
from repro_torch.models.model import f32_param_count, param_dtype
from repro_torch.models.params import NORM_TENSORS
from repro_torch.runtime import ChaosMonkey, GuardMetrics, PreemptionGuard, StepGuard

# Room kept for activations beside the training step's own bytes
# (``train_step_peak_bytes``) when the CLI decides whether a config fits the
# card. At batch 4 x seq 512 the full-width runs on an H100 peaked within
# 0.1 GB of that model (internlm2-1.8b 41.64 GB against 41.57,
# recurrentgemma-9b at 3 layers 67.10 against 67.03; PERF.md section 5):
# under remat the activations take little beside AdamW's peak.
ACTIVATION_RESERVE_BYTES = 8 * 10**9


def param_leaves(cfg) -> int:
    """Tensors in ``init_params(cfg)``: per attention block, global or
    local, the mixer's four weights (MLA: five projections and two latent
    norm scales), per cross-attention block five (the four and the 0-d
    gate), per RG-LRU block seven (three projections, the conv weight, the
    two gate blocks and ``lam``), each with the FFN's two or three (an MoE
    FFN: the router and the two or three stacked expert tensors) and two
    norms; per SSM block its nine mixer tensors and one norm (no FFN); the
    embedding, the final norm and an untied head (with codebooks one (K,
    vocab, d) table and one (K, d, padded vocab) head). A norm is one
    tensor for an RMSNorm (its scale), two for a LayerNorm (scale and
    bias), none for OLMo's non-parametric LayerNorm."""
    norm = NORM_TENSORS[cfg.norm]
    ffn = (3 if cfg.ffn_kind == "swiglu" else 2) + (cfg.moe is not None)
    mix = {"rec": 7, "xattn": 5}
    n = sum(9 + norm if kind == "ssm" else
            mix.get(kind, 7 if cfg.mla is not None else 4) + ffn + 2 * norm
            for kind in cfg.pattern_layers)
    return n + 1 + norm + (not cfg.tie_embeddings)


def train_state_bytes(cfg, tcfg) -> int:
    """Bytes of the training state before activations: the parameters and
    their gradients at the parameters' dtype (the MoE routers and the SSM
    blocks' dt_bias, A_log and D at f32), AdamW's f32 first moment and its
    f32 second moment (one scalar a group with ``fused_second_moment``,
    counted as none); past ``PARTS_KERNEL_MAX`` leaves also the clip
    statistic's pack, which holds every gradient squared at f32 and then
    their concatenation (8 bytes a parameter at its peak). The fit check
    charges the whole step instead (``train_step_peak_bytes``)."""
    item = torch.empty((), dtype=param_dtype(cfg)).element_size()
    per = 2 * item + (4 if tcfg.fused_second_moment else 8)
    if param_leaves(cfg) > PARTS_KERNEL_MAX:
        per += 8
    return cfg.param_count() * per + f32_param_count(cfg) * 2 * (4 - item)


# f32 temporaries the size of one leaf that ``optim.adamw._adamw_core``
# holds at once: 7 on its unfused path (g * clip, m / bc1, v / bc2, p at
# f32, delta, lr * delta and p - lr * delta, or sqrt(v / bc2) + eps and the
# quotient on the way to delta), fewer on the fused one; the guarded step
# adds its two candidate moments. Each leaf's update runs in a function of
# its own, so no temporary outlives its leaf.
ADAMW_LEAF_TEMPS = 7
GUARD_LEAF_TEMPS = 2


def param_shapes(cfg) -> list:
    """``(numel, element size)`` of every tensor ``init_params(cfg)`` makes,
    in ``reduce.tree_leaves`` order: built on the meta device, so nothing
    is allocated."""
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    return [(p.numel(), p.element_size()) for p in R.tree_leaves(params)]


def train_step_peak_bytes(cfg, tcfg, *, guard: bool = False) -> int:
    """Device bytes a training step holds at its peak, activations aside,
    from the parameters' shapes (``param_shapes``): the larger of
      the backward's end: the parameters, AdamW's f32 moments (one f32
        tensor with ``fused_second_moment``), the f32 gradient accumulators
        and one microbatch's gradients at the parameters' dtypes;
      the update: the parameters, the moments and the averaged f32
        gradients (averaged in place), with the larger of the clip
        statistic's pack (past ``PARTS_KERNEL_MAX`` leaves: every gradient
        squared at f32, then their concatenation, 8 bytes a parameter) and
        AdamW's f32 temporaries of the largest leaf (``ADAMW_LEAF_TEMPS``,
        with ``guard`` also ``GUARD_LEAF_TEMPS``)."""
    shapes = param_shapes(cfg)
    n = sum(k for k, _ in shapes)
    params = sum(k * size for k, size in shapes)
    moments = 4 * n * (1 if tcfg.fused_second_moment else 2)
    backward = params + moments + 4 * n + params
    temps = 4 * max(k for k, _ in shapes) * (ADAMW_LEAF_TEMPS + guard * GUARD_LEAF_TEMPS)
    pack = 8 * n if len(shapes) > PARTS_KERNEL_MAX else 0
    return max(backward, params + moments + 4 * n + max(pack, temps))


def combine_peak_bytes(cfg, world: int) -> int:
    """Device bytes the data mesh's gradient combine adds at its peak: the
    gathered f32 rows of the largest leaf (one a rank) and the fold's
    accumulator."""
    return 4 * max(k for k, _ in param_shapes(cfg)) * (world + 1)


def check_fits_card(cfg, tcfg, device, *, guard: bool = False, ranks_on_card: int = 1,
                    world: int = 1) -> None:
    """Refuse, before any allocation, a config whose training step
    (``train_step_peak_bytes``, guarded or not) and the activation reserve
    (``ACTIVATION_RESERVE_BYTES``) exceed the card: deepseek-7b (152 GB),
    minicpm3-4b at full depth (93.8 GB), recurrentgemma-9b past 6 layers
    (past 3 guarded) and llama-3.2-vision-11b at full depth are refused on
    an 80 GB card. Under a data mesh of ``world`` ranks (``world`` > 1)
    the step, the reserve and the combine's buffers
    (``combine_peak_bytes``) are charged once for each of the
    ``ranks_on_card`` ranks that share the card."""
    if device.type != "cuda":
        return
    per_rank = train_step_peak_bytes(cfg, tcfg, guard=guard) + ACTIVATION_RESERVE_BYTES
    if world > 1:
        per_rank += combine_peak_bytes(cfg, world)
    need = per_rank * ranks_on_card
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        ranks = f" for each of {ranks_on_card} ranks on the card" if ranks_on_card > 1 else ""
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers: the {'guarded ' * guard}training step "
            f"holds {(per_rank - ACTIVATION_RESERVE_BYTES) / 1e9:.1f} GB before activations "
            f"(and {ACTIVATION_RESERVE_BYTES / 1e9:.0f} GB are kept for them){ranks}, "
            f"{need / 1e9:.1f} GB, more than the card's {have / 1e9:.1f} GB; it trains at "
            f"this depth only when the ROADMAP's sharding item (FSDP/TP and expert "
            f"parallelism) shards it")


def build(cfg, tcfg, device, params=None, *, guard: bool = False, spike_z: float = 6.0,
          data_mesh=None):
    """Parameters (seeded random unless given; they are set to require
    grad), optimizer state and the train step: ``make_train_step``'s, or
    with ``guard`` ``make_guarded_train_step``'s (which also takes and
    returns the guard state), or with ``data_mesh`` too
    ``make_mesh_guarded_train_step``'s."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, device)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = optim.init_state(
        params, fused_second_moment=tcfg.fused_second_moment,
        leaf_groups=reference_leaf_groups(params, cfg),
    )
    if data_mesh is not None:
        step_fn = make_mesh_guarded_train_step(cfg, tcfg, data_mesh, spike_z=spike_z)
    elif guard:
        step_fn = make_guarded_train_step(cfg, tcfg, spike_z=spike_z)
    else:
        step_fn = make_train_step(cfg, tcfg)
    return params, opt_state, step_fn


def _restore(ckpt, step: int, params, opt_state):
    """The committed state of ``step`` in place of the live one (the live
    tensors are released); the restored parameters require grad."""
    params, opt_state = ckpt.restore(step, (params, opt_state))
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    return params, opt_state, ckpt.manifest(step)["extra"]["data_step"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument(
        "--fused-second-moment", action="store_true",
        help="olmax-style scalar v EMA per reference leaf, fed by the norm "
        "launch's per-leaf sumsq slots",
    )
    ap.add_argument(
        "--guard", action="store_true",
        help="guarded step: the clip statistic's launch also counts NaN/Inf "
        "grad elements (in-launch census); a poisoned or loss-spiking step "
        "passes params and optimizer state through bitwise unchanged, and "
        "--max-bad-steps consecutive skips roll back to the last committed "
        "checkpoint (requires --ckpt-dir for rollback)",
    )
    ap.add_argument("--spike-window", type=int, default=16,
                    help="guarded step: accepted-loss window length for the median/MAD "
                    "loss-spike detector")
    ap.add_argument("--spike-z", type=float, default=6.0,
                    help="guarded step: robust z-score above the window median that forces "
                    "a skip")
    ap.add_argument("--max-bad-steps", type=int, default=3,
                    help="guarded step: consecutive skipped steps before rollback")
    ap.add_argument(
        "--chaos", type=float, default=0.0,
        help="deterministic fault-injection drill: per-step probability of an injected "
        "fault (half NaN-poisoned grads, half transient step failure), scheduled by "
        "--chaos-seed (requires --guard)",
    )
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the --chaos schedule (same seed = same faults on every "
                    "rerun)")
    ap.add_argument("--status-path", default=None,
                    help="guard-metrics JSON status file, rewritten atomically at every "
                    "checkpoint commit (default: <ckpt-dir>/guard_status.json)")
    ap.add_argument(
        "--reduce-backend", default=None, choices=R.available_backends() + ("auto",),
        help="process-wide repro_torch.reduce backend (default: the config flags)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    ap.add_argument(
        "--mesh", action="store_true",
        help="data-parallel guarded step over every rank (start them with torchrun) with "
        "the deterministic fixed-order gradient combine, so the skip and rollback "
        "decisions are bitwise the same on every rank (requires --guard; --batch must "
        "divide by the world)",
    )
    ap.add_argument("--chaos-host", type=int, default=0,
                    help="with --mesh, the rank whose local gradients the NaN drill poisons: "
                    "the combined census must still skip on every rank in lockstep")
    return ap


def main(argv=None, *, cfg=None, chaos: ChaosMonkey | None = None):
    """Run the CLI. ``cfg`` (a ``ModelConfig``) replaces ``--arch``'s
    configuration and ``chaos`` (a ``ChaosMonkey``) the ``--chaos``
    schedule: the entries for callers that cut depth or name the faulted
    steps. Returns the loss of every step taken, replays after a rollback
    included."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh and not args.guard:
        ap.error("--mesh requires --guard")
    if (args.chaos or chaos is not None) and not args.guard:
        ap.error("--chaos requires --guard")
    if not args.mesh:
        return _train(ap, args, resolve_device(args.device), cfg, chaos)
    _, world, _, local_world = mesh_lib.rank_env()
    if args.batch % world:
        ap.error(f"--batch {args.batch} must divide by the {world} ranks of the mesh")
    _, world, device, transport = mesh_lib.init_process_group(args.device)
    try:
        data_mesh = mesh_lib.make_data_mesh()
        print(f"mesh guard: {world}-way data mesh over {transport}, deterministic combine")
        ranks = mesh_lib.ranks_per_card(local_world) if device.type == "cuda" else 1
        losses = _train(ap, args, device, cfg, chaos, data_mesh, ranks)
    except BaseException:
        mesh_lib.shutdown(barrier=False)  # a failed rank must not wait on the others
        raise
    mesh_lib.shutdown()
    return losses


def _train(ap, args, device, cfg, chaos, data_mesh=None, ranks_on_card: int = 1):
    """The CLI's run on ``device``; with ``data_mesh`` (a bound process
    group) the data-parallel guarded step on this rank."""
    rank = 0 if data_mesh is None else data_mesh.rank
    world = 1 if data_mesh is None else data_mesh.size
    lead = rank == 0  # the rank that writes checkpoints and the status file
    if args.reduce_backend:
        R.set_default_backend(args.reduce_backend)
    if cfg is None:
        cfg = get_arch(args.arch, tiny=args.tiny)
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10), microbatches=args.microbatches,
        fused_second_moment=args.fused_second_moment,
    )
    try:
        check_fits_card(cfg, tcfg, device, guard=args.guard, ranks_on_card=ranks_on_card,
                        world=world)
    except ValueError as e:
        ap.error(str(e))
    params, opt_state, step_fn = build(cfg, tcfg, device, guard=args.guard,
                                       spike_z=args.spike_z, data_mesh=data_mesh)
    n_params = sum(p.numel() for p in R.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M steps={args.steps} device={device}")

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, ShardInfo(), seed=tcfg.seed,
                       n_codebooks=cfg.n_codebooks)
    ctx = None
    if cfg.n_img_tokens:
        ctx = synth_image_embeds(torch.Generator(device=device).manual_seed(1), args.batch,
                                 cfg.n_img_tokens, cfg.d_model, param_dtype(cfg), device)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if chaos is None and args.chaos > 0:
        chaos = ChaosMonkey.from_seed(args.chaos_seed, n_steps=args.steps,
                                      nan_rate=args.chaos / 2, fail_rate=args.chaos / 2,
                                      host=args.chaos_host)
    if chaos is not None:
        origin = f"seed={args.chaos_seed} rate={args.chaos}" if args.chaos > 0 else "given"
        host = f" host={chaos.host}" if data_mesh is not None else ""
        print(f"chaos: {origin} nan_steps={sorted(chaos.nan_steps)} "
              f"fail_steps={sorted(chaos.fail_steps)}{host}")

    def barrier():
        if data_mesh is not None:
            torch.distributed.barrier()

    guard_state = optim.init_guard_state(args.spike_window, device) if args.guard else None
    step_guard = StepGuard(args.max_bad_steps) if args.guard else None
    gmetrics = GuardMetrics() if args.guard else None
    status_path = args.status_path
    if status_path is None and args.ckpt_dir:
        status_path = os.path.join(args.ckpt_dir, "guard_status.json")
    start_step = 0
    if ckpt and ckpt.latest() is not None:
        ckpt.wait()  # drain any mid-flush save of an earlier incarnation
        start_step = ckpt.latest()
        params, opt_state, data_step = _restore(ckpt, start_step, params, opt_state)
        data.seek(data_step)
        print(f"resumed from step {start_step}")
    barrier()  # every rank has read the directory before the lead writes to it
    if args.guard and ckpt and ckpt.latest() is None and lead:
        # anchor commit: a guard trip before the first periodic save still
        # has a rollback target
        ckpt.save(0, (params, opt_state), extra={"data_step": data.state()["step"]})
        print("anchor commit step 0")
    # created after any resume's seek, so its first batch is the resumed one
    prefetch = None if args.guard else Prefetcher(data)
    preempt = PreemptionGuard()

    losses = []
    t0 = time.time()
    step = start_step
    try:
        while step < args.steps:
            batch = data.next() if prefetch is None else prefetch.next()
            feed = {"tokens": torch.from_numpy(batch["tokens"]).to(device)}
            if ctx is not None:
                feed["image_embeds"] = ctx
            if chaos is not None:
                # keyed on step + 1, the step being taken; fire-once keeps
                # a post-rollback replay clean. Under the mesh one entry a
                # rank, of which --chaos-host's is poisoned
                ones = torch.ones((world,), dtype=torch.float32, device=device)
                feed["chaos_scale"] = (chaos.corrupt(ones, step + 1) if data_mesh is None
                                       else chaos.corrupt_shard(ones, step + 1, shards=world))

            def attempt():
                if chaos is not None:
                    chaos.on_step(step + 1, preempt)
                if args.guard:
                    return step_fn(params, opt_state, guard_state, feed)
                return step_fn(params, opt_state, feed)

            if step_guard is not None:
                failures_before = step_guard.transient_failures
                out = step_guard.retry(attempt)
                retries = step_guard.transient_failures - failures_before
                gmetrics.record_retry(retries)
                if retries:
                    print(f"guard: step {step + 1} retried after {retries} transient "
                          f"fault(s)")
            else:
                out = attempt()
            if args.guard:
                params, opt_state, guard_state, metrics = out
            else:
                params, opt_state, metrics = out
            del out  # a rollback below must leave no reference to the state it replaces
            losses.append(float(metrics["loss"]))
            step += 1
            skipped = False
            if step_guard is not None:
                skipped = float(metrics["skipped"]) > 0.0
                if skipped:
                    print(f"guard: step {step} skipped (nonfinite "
                          f"{float(metrics['nonfinite']):.0f}, spike "
                          f"{float(metrics['spike']):.0f})")
            if step % args.log_every == 0 or step == args.steps:
                n = (step - 1) % args.log_every + 1
                dt = (time.time() - t0) / n
                extra = ""
                if args.guard:
                    extra = (f" nonfinite {float(metrics['nonfinite']):.0f}"
                             f" skips {int(guard_state.skipped)}")
                print(
                    f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step" + extra
                )
                t0 = time.time()
            if data_mesh is not None:
                # the metrics at full precision: every rank prints the same bits
                print(f"mesh step {step} rank {rank}: loss {float(metrics['loss'])!r} gnorm "
                      f"{float(metrics['grad_norm'])!r} clip {float(metrics['clip'])!r} "
                      f"nonfinite {float(metrics['nonfinite']):.0f} skipped "
                      f"{float(metrics['skipped']):.0f}; combine {metrics['combine_s']:.4f} s "
                      f"{metrics['combine_bytes']} B over {data_mesh.backend}", flush=True)
            if step_guard is not None:
                step_guard.record(skipped)
                gmetrics.record_step(step, skipped=skipped,
                                     census_total=float(metrics["nonfinite"]))
                if step_guard.should_rollback():
                    if ckpt is None:
                        print("guard: rollback wanted but no --ckpt-dir; resetting the "
                              "bad-step counter only")
                        step_guard.reset()
                    else:
                        ckpt.wait()
                        barrier()  # the lead's commits are on disk for every rank
                        back = ckpt.latest()
                        params, opt_state, data_step = _restore(ckpt, back, params,
                                                                opt_state)
                        data.seek(data_step)
                        guard_state = optim.init_guard_state(args.spike_window, device)
                        step_guard.reset()
                        step_guard.rollbacks += 1
                        gmetrics.record_rollback()
                        if status_path and lead:
                            gmetrics.write(status_path)
                        print(f"guard: rolled back to step {back} (data step {data_step})")
                        step = back
                    continue
            # never commit mid-skip-streak (see TrainSupervisor.run)
            if ckpt and ((step % args.ckpt_every == 0 and not skipped)
                         or preempt.should_stop):
                if lead:
                    ckpt.save(step, (params, opt_state),
                              extra={"data_step": data.state()["step"]})
                if gmetrics is not None:
                    gmetrics.record_commit()
                    if status_path and lead:
                        gmetrics.write(status_path)
                    snap = gmetrics.snapshot()
                    print(f"commit step {step}: skipped {snap['steps_skipped']}/"
                          f"{snap['steps_total']} retries {snap['retries']} "
                          f"rollbacks {snap['rollbacks']}")
                else:
                    print(f"commit step {step}")
            if preempt.should_stop:
                print("preempted: checkpoint flushed, exiting cleanly")
                break
    finally:
        preempt.uninstall()
        if prefetch is not None:
            prefetch.close()
        if ckpt:
            ckpt.wait()
    if ckpt:
        for r in ckpt.records:
            if r["op"] == "save":
                what = (f"snapshot {r['snapshot_s']:.3f} s, flush "
                        f"{r.get('flush_s', float('nan')):.3f} s")
            else:
                what = f"{r['seconds']:.3f} s" + (", CRC verified" if r["verified"] else "")
            print(f"checkpoint {r['op']} step {r['step']}: {r['bytes']} bytes, {what}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
