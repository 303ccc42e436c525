"""Rank workers of the port's data-mesh tests: CPU ranks under
``torch.multiprocessing.spawn`` on gloo, one spawn per world size.

Imports only torch, numpy and the port (each rank is a fresh process, and
the reference package would only cost it memory). ``run(name, world,
tmp, *args)`` starts ``world`` ranks that each call ``name(rank, world,
*args)`` with a data mesh bound, and returns what every rank returned, in
rank order."""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.core import collectives as C
from repro_torch.launch import mesh as mesh_lib


def run(name: str, world: int, tmp, *args) -> list:
    import torch.multiprocessing as mp

    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(world, str(tmp), name, args), nprocs=world)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, tmp: str, name: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh_lib.init_process_group("cpu", init_method=f"file://{tmp}/store")
    try:
        mesh = mesh_lib.make_data_mesh()
        with C.bound_mesh(mesh):
            out = globals()[name](rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        mesh_lib.shutdown(barrier=False)
        raise
    mesh_lib.shutdown()


def _rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    """This rank's equal share of x's leading axis."""
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _nudged(fn):
    """``fn`` whose result is moved by one ulp: a fold that desynced."""
    def wrong(*args, **kwargs):
        out = fn(*args, **kwargs)
        return torch.nextafter(out, torch.full_like(out, float("inf")))
    return wrong


# ------------------------------- collectives ----------------------------------


def collectives(rank, world, cases):
    """The reference test's collectives on rank ``rank``'s row of each
    (8, 16) case: ring, per-axis all-reduce, fixed-order combine, the
    census agreement, the desync detector, the compressed sum, the meter's
    bytes, and the planted faults."""
    from repro_torch.core.cost_model import interconnect_bytes
    from repro_torch.reduce import inspect

    out = {}
    for name, x in cases.items():
        xs = _rows(x, rank, world)
        row = torch.stack([torch.sum(~torch.isfinite(xs)).to(torch.float32)])
        combined, agree = C.census_agreement(row, ("data",))
        out[name] = dict(
            ring=C.ring_all_reduce(xs, "data"), hier=C.hierarchical_psum(xs, ("data",)),
            fo=C.fixed_order_combine(xs, ("data",)), combined=combined, agree=bool(agree),
            desync=bool(C.replica_bits_agree(torch.tensor(float(rank)), ("data",))),
            local_mma=C.local_mma_then_psum(xs, ("data",), backend="mma_torch"),
        )
        if name != "nan":
            cout, err = C.compressed_psum(xs, "data", torch.zeros_like(xs))
            out[name].update(compressed=cout, err=err)
            g, _ = C.hierarchical_grad_reduce(xs, dense_axes=("data",), compressed_axis=None)
            out[name]["grad_reduce"] = g
    xs = _rows(cases["normal"], rank, world)
    out["recv_bytes"] = inspect.collective_recv_bytes(C.fixed_order_combine, xs, ("data",))
    out["recv_model"] = interconnect_bytes(xs.numel(), world).recv_per_device
    out["ops"] = [op for op, _, _ in inspect.collective_eqns(C.ring_all_reduce, xs, "data")]
    # planted faults: a replicated value one ulp off on rank 1, and rank 1's
    # fold desynced by one ulp, must both be seen on every rank
    rep = C.fixed_order_combine(xs, ("data",))
    if rank == 1:
        rep = torch.nextafter(rep, torch.full_like(rep, float("inf")))
    out["fault_bits_agree"] = bool(C.replica_bits_agree(rep, ("data",)))
    # a 0-d 16-bit leaf (a bf16 gate) travels as bytes too
    gate = torch.tensor(0.5 + (rank == 1) * 2**-8, dtype=torch.bfloat16)
    out["gate_bits_agree"] = (bool(C.replica_bits_agree(torch.tensor(0.5, dtype=torch.bfloat16),
                                                        ("data",))),
                              bool(C.replica_bits_agree(gate, ("data",))))
    real = C.fixed_order_combine
    if rank == 1:
        C.fixed_order_combine = _nudged(real)
    try:
        _, fault_agree = C.census_agreement(torch.ones(3), ("data",))
    finally:
        C.fixed_order_combine = real
    out["fault_census_agree"] = bool(fault_agree)
    return out


# ----------------------------- the mesh reduce --------------------------------


def mesh_reduce(rank, world, x, tree, backends, tree_backends):
    """``reduce`` (sum, sumsq, norm2, mean, moments), ``reduce_many`` and
    ``reduce_tree(census=True)`` with ``mesh_axes="data"`` on this rank's
    rows, each backend twice (run-to-run bits)."""
    xs = _rows(x, rank, world)
    many = [_rows(np.ascontiguousarray(x[:, :40]), rank, world),
            _rows(np.ascontiguousarray(x[:, 40:47]), rank, world)]
    out = {}
    for backend in backends:
        runs = []
        for _ in range(2):
            outs = [R.reduce(xs, kind=k, backend=backend, mesh_axes=("data",))
                    for k in ("sum", "sumsq", "norm2", "mean")]
            mu, var = R.reduce(xs, kind="moments", backend=backend, mesh_axes=("data",))
            mv = R.reduce_many(many, kind="sumsq", backend=backend, mesh_axes=("data",))
            mmean = R.reduce_many(many, kind="mean", backend=backend, mesh_axes="data")
            census = R.reduce(xs, kind="norm2", backend=backend, census=True,
                              mesh_axes="data")
            runs.append(torch.cat([torch.stack(outs + [mu, var]), mv, mmean,
                                   torch.stack(list(census))]))
        out[backend] = runs
    leaves = {k: _rows(v, rank, world) for k, v in tree.items()}
    for backend in tree_backends:
        norm, counts = R.reduce_tree(leaves, "norm2", backend=backend, census=True,
                                     mesh_axes=("data",))
        per, fork, counts2 = R.reduce_tree(leaves, "norm2", backend=backend, census=True,
                                           mesh_axes="data", return_per_leaf=True,
                                           epilogue=[(), ("clip_coeff", 1.0, 1e-9)])
        out[f"tree_{backend}"] = dict(norm=norm, counts=counts, per=per, fork=fork,
                                      counts2=counts2)
    return out


def lockstep(rank, world, w, b, base_w, base_b, steps):
    """The reference's lockstep scenario: FSDP-style shards, one host's
    shard poisoned at steps 3-5 by the chaos injector, per-rank
    ``StepGuard``s."""
    from repro_torch.configs import TrainConfig
    from repro_torch.runtime import ChaosMonkey, StepGuard

    tcfg = TrainConfig(learning_rate=1e-2, total_steps=20, warmup_steps=1)
    params = {"w": _rows(w, rank, world).clone(), "b": _rows(b, rank, world).clone()}
    state = optim.init_state(params)
    guard = optim.init_guard_state(8)
    loss = torch.tensor(1.0)
    monkey = ChaosMonkey(nan_steps=(3, 4, 5), host=2)
    step_guard = StepGuard(max_bad_steps=3, sleep=lambda s: None)
    record, rollback_at = [], None
    for t in range(1, steps + 1):
        gw = monkey.corrupt_shard(torch.from_numpy(base_w), t, shards=world)
        grads = {"w": gw[rank * (8 // world):(rank + 1) * (8 // world)].clone(),
                 "b": _rows(base_b, rank, world)}
        before = [p.clone() for p in R.tree_leaves(params)]
        params, state, guard, m = optim.guarded_apply_updates(
            params, grads, state, tcfg, loss=loss, guard=guard, reduce_backend="cuda_fused",
            mesh_axes=("data",))
        skipped = float(m["skipped"]) > 0.0
        unchanged = all(torch.equal(a.view(torch.int32), c.view(torch.int32))
                        for a, c in zip(before, R.tree_leaves(params)))
        record.append({k: m[k].clone() for k in ("skipped", "grad_norm", "nonfinite", "clip")}
                      | {"unchanged": unchanged})
        step_guard.record(skipped)
        if rollback_at is None and step_guard.should_rollback():
            rollback_at = t
    return dict(steps=record, rollback_at=rollback_at, params=params)


# -------------------------- the data-mesh guarded step --------------------------


def mesh_step(rank, world, params_path, tokens, scales, backend):
    """``make_mesh_guarded_train_step`` on tiny olmo-1b: the global batch
    of each step, its (world,) chaos scales, the metrics (with the bytes
    the meter saw the step's all-gathers bring in, ``recv_bytes``) and the
    final parameters of this rank."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.reduce import inspect

    R.set_default_backend(backend)
    cfg = get_arch("olmo-1b", tiny=True)
    tcfg = TrainConfig(total_steps=len(tokens), warmup_steps=1)
    params = torch.load(params_path, weights_only=False)
    mesh = C.current_mesh()
    params, opt, step = train_cli.build(cfg, tcfg, "cpu", params=params, guard=True,
                                        data_mesh=mesh)
    guard = optim.init_guard_state(16)
    metrics = []
    for tok, sc in zip(tokens, scales):
        batch = {"tokens": torch.from_numpy(tok)}
        if sc is not None:
            batch["chaos_scale"] = torch.from_numpy(sc)
        out = []
        recv = inspect.collective_recv_bytes(
            lambda: out.append(step(params, opt, guard, batch)))
        params, opt, guard, m = out[0]
        metrics.append({k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
        metrics[-1]["recv_bytes"] = recv
    R.set_default_backend(None)
    return dict(metrics=metrics, params=[p.detach().clone() for p in R.tree_leaves(params)])


def mesh_step_world1_bitwise(rank, world, params_path, tokens, backend):
    """At world 1 a clean mesh step is bitwise ``make_guarded_train_step``'s:
    both from the same parameters on the same batches."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli

    R.set_default_backend(backend)
    cfg = get_arch("olmo-1b", tiny=True)
    tcfg = TrainConfig(total_steps=len(tokens), warmup_steps=1)
    runs = []
    for mesh in (C.current_mesh(), None):
        params = torch.load(params_path, weights_only=False)
        params, opt, step = train_cli.build(cfg, tcfg, "cpu", params=params, guard=True,
                                            data_mesh=mesh)
        guard = optim.init_guard_state(16)
        losses = []
        for tok in tokens:
            params, opt, guard, m = step(params, opt, guard, {"tokens": torch.from_numpy(tok)})
            losses.append(m["loss"].clone())
        runs.append(dict(losses=losses, params=[p.detach().clone() for p in
                                                 R.tree_leaves(params)],
                         m=[t.clone() for t in opt.m], v=[t.clone() for t in opt.v]))
    R.set_default_backend(None)
    return runs


def calls(rank, world, todo):
    """Several workers in one spawn: ``{name: name(rank, world, *args)}``."""
    return {name: globals()[name](rank, world, *args) for name, args in todo}


def agreement(rank, world, root, leaves):
    """Each rank's ``step_fingerprint`` of a ``reduce_tree(census=True,
    mesh_axes=)`` over its shards (per-leaf sums, norm and clip, counts,
    skip), exchanged over a ``FileTransport``: step 1 clean; step 2 with
    rank 1's first per-leaf sum moved by one ulp. Returns what each
    exchange said."""
    from repro_torch.runtime import AgreementChecker, DivergenceError, FileTransport, exchange
    from repro_torch.runtime import step_fingerprint

    mine = [_rows(x, rank, world) for x in leaves]
    per, fork, counts = R.reduce_tree(mine, "norm2", backend="cuda_fused", census=True,
                                      return_per_leaf=True, epilogue=[(), ("clip_coeff", 1.0,
                                                                           1e-9)],
                                      mesh_axes="data")
    skipped = (counts[-1] > 0).to(torch.float32)
    out = {}
    for step, nudge in ((1, False), (2, True)):
        stat = torch.cat([per, fork])  # the clean leaf's slot is finite: a nudge shows
        if nudge and rank == 1:
            stat[0] = torch.nextafter(stat[0], torch.tensor(float("inf")))
        fp = step_fingerprint(step, counts, skipped, stat)
        try:
            out[step] = exchange(AgreementChecker(world), FileTransport(root), step, rank, fp,
                                 timeout_s=60.0)
        except DivergenceError as e:
            out[step] = ("divergence", e.step, e.host)
    return out


def meshes(rank, world):
    """``make_host_mesh`` and ``batch_axes`` on this rank, and a
    fixed-order combine over the host mesh's ("data", "model") axes."""
    host = mesh_lib.make_host_mesh()
    with C.bound_mesh(host):
        total = C.fixed_order_combine(torch.tensor([float(rank + 1)]), ("data", "model"))
    return dict(shape=host.shape, axes=host.axis_names, data_group=host.groups["data"] is None,
                batch=mesh_lib.batch_axes(host), data_batch=mesh_lib.batch_axes(C.current_mesh()),
                total=float(total), world=C.mesh_world_size(("data",)))


# ----------------------------- the sharded step --------------------------------
# ``run_mesh`` spawns the ranks of a mesh that splits the world, e.g. (2, 2)
# over ("data", "model"), each with its own deadline.

SPAWN_TIMEOUT_S = 300


def run_mesh(name: str, shape: tuple, axes: tuple, tmp, *args,
             timeout: float = SPAWN_TIMEOUT_S) -> list:
    """``name(rank, mesh, *args)`` on every rank of a ``shape`` mesh over
    ``axes`` (gloo CPU ranks); what every rank returned, in rank order.
    The ranks are ended and the call raises when they pass ``timeout``
    seconds (a rank waiting on a group another never joined)."""
    import time

    import torch.multiprocessing as mp

    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    world = int(np.prod(shape))
    ctx = mp.spawn(_mesh_entry, args=(world, str(tmp), name, tuple(shape), tuple(axes), args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{name}: the ranks of {shape} passed {timeout} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _mesh_entry(rank, world, tmp, name, shape, axes, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh_lib.init_process_group("cpu", init_method=f"file://{tmp}/store")
    try:
        out = globals()[name](rank, mesh_lib.make_mesh(shape, axes), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        mesh_lib.shutdown(barrier=False)
        raise
    mesh_lib.shutdown()


def exact_f32_attention():
    """The attention's bf16 rounding of its operands off (the f32 cases;
    MLA's decode reads the same switch): it turns a last-bit difference of
    a product taken on a rank's columns into a bf16 ulp, which would hide
    the sharding's own agreement."""
    from repro_torch.models import attention

    attention.bf16_round = lambda x: x


def sharded_cfg(arch: str, dtype: str, kernels: bool):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch, tiny=True), dtype=dtype, use_kernels=kernels,
                               mma_reductions=kernels)


def open_gates(params, cfg, value: float) -> None:
    """Every cross-attention gate of ``params`` set to ``value``, in place.
    At init the gates are 0: the block then adds nothing, its q, k, v and
    o get no gradient, and a fault in its tensor parallelism would not
    show (a trained model's gates are open)."""
    for kind, layer in zip(cfg.pattern_layers, params["layers"]):
        if kind == "xattn":
            layer["mix"]["gate"].fill_(value)


def _replicas_agree(params, specs, mesh) -> bool:
    """Every leaf's bits equal across the ranks of each axis its spec
    leaves whole (a replicated leaf is the same on every rank)."""
    from repro_torch.launch import sharding as SH

    ok = True
    for p, s in zip(R.tree_leaves(params), SH.tree_leaves(specs)):
        whole = tuple(ax for ax in mesh.axis_names if ax not in SH.spec_axes(s))
        if whole:
            ok &= bool(C.replica_bits_agree(p.detach(), whole, mesh))
    return ok


def _nudge_one_rank(rank: int):
    """Rank 1's Megatron all-reduce (``sum_forward``) comes out 2^-10 too
    large: a fold that desynced on one rank. Returns the undo."""
    from repro_torch.core import collectives as coll

    real = coll._SumForward.forward

    def wrong(ctx, x, axes, mesh):
        out = real(ctx, x, axes, mesh)
        return out * (1 + 2**-10) if rank == 1 else out

    coll._SumForward.forward = staticmethod(wrong)

    def undo():
        coll._SumForward.forward = staticmethod(real)

    return undo


class _OwnPartBackward(torch.autograd.Function):
    """Megatron's f with its sum dropped: the backward still runs the
    all-reduce (the ranks stay in lockstep) but keeps the rank's own part
    of the gradient."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        C.fixed_order_combine(g, ctx.axes, ctx.mesh)
        return g, None, None


def _dropped_f(tp, x):
    return _OwnPartBackward.apply(x, C._block_axes(tp.axis), tp.mesh)


class _SumForwardOnly(torch.autograd.Function):
    """A statistic summed over the ranks forward only: the backward still
    runs the all-reduce (the ranks stay in lockstep) but keeps the rank's
    own part of the gradient."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return C.fixed_order_combine(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        C.fixed_order_combine(g, ctx.axes, ctx.mesh)
        return g, None, None


class _PlantedTP:
    """A mixer's ``models.parallel.TP`` with its f (``enter``), g
    (``exit``) or two-way sum (``both``) replaced by ``enter(tp, x)`` /
    ``exit(tp, y)`` / ``both(tp, s)``."""

    def __init__(self, tp, enter=None, exit=None, both=None):
        self.tp, self._enter, self._exit, self._both = tp, enter, exit, both
        self.mesh, self.axis = tp.mesh, tp.axis

    def enter(self, x):
        return (self._enter or type(self.tp).enter)(self.tp, x)

    def exit(self, y):
        return (self._exit or type(self.tp).exit)(self.tp, y)

    def both(self, s):
        return (self._both or type(self.tp).both)(self.tp, s)


def _plant_mixer_fault(rank: int, kind: str):
    """A planted fault in one mixer's tensor parallelism, on global rank 1
    (data 0, model 1); returns the undo.

      mla    f dropped on the shared RoPE key (``_expand``'s third f):
             kv_down's rope columns and everything before them get that
             rank's heads' part of its gradient alone
      rec    the RG-LRU's g comes out 2^-10 too large
      xattn  f dropped on the query input: a backward fault, which only a
             nonzero gate shows
      ssm    the gated norm's statistic summed over "model" forward only:
             its gradient stays the rank's part (a backward fault)
    A dropped f or sum still runs its all-reduce (``_OwnPartBackward``,
    ``_SumForwardOnly``): a rank that skipped it would leave the others
    waiting.
    """
    from repro_torch.models import attention, mla, rglru, ssm

    module, name = {"mla": (mla, "mla_train"), "rec": (rglru, "rglru_train"),
                    "xattn": (attention, "cross_attention_apply"),
                    "ssm": (ssm, "ssm_train")}[kind]
    real = getattr(module, name)

    def planted_tp(tp):
        if kind == "mla":
            calls = [0]

            def enter(t, x):  # cq, ckv, then the RoPE key
                calls[0] += 1
                return _dropped_f(t, x) if calls[0] == 3 else type(t).enter(t, x)
            return _PlantedTP(tp, enter=enter)
        if kind == "rec":
            return _PlantedTP(tp, exit=lambda t, y: type(t).exit(t, y) * (1 + 2**-10))
        if kind == "ssm":
            return _PlantedTP(tp, both=lambda t, s: _SumForwardOnly.apply(
                s, C._block_axes(t.axis), t.mesh))
        return _PlantedTP(tp, enter=_dropped_f)

    def wrong(*args, tp=None, **kwargs):
        if tp is not None and rank == 1:
            tp = planted_tp(tp)
        return real(*args, tp=tp, **kwargs)

    setattr(module, name, wrong)
    return lambda: setattr(module, name, real)


def _plant_book_offset(rank: int):
    """Global rank 1's codebook lookup takes its rows' offset from
    ``Plan.vocab0`` (the head's, in the padded vocabulary), not from the
    table's own block start: tiny musicgen's rank 1 holds rows 32-63 of 64
    but looks them up from 128, so those tokens get zero rows. Returns the
    undo."""
    from repro_torch.models import parallel

    real = parallel.Plan.__init__

    def wrong(self, *args, **kwargs):
        real(self, *args, **kwargs)
        if rank == 1:
            self.book0 = self.vocab0

    parallel.Plan.__init__ = wrong
    return lambda: setattr(parallel.Plan, "__init__", real)


def _plant_ema_counts(rank: int):
    """Global rank 1's fused second moment sizes its groups by the rank's
    blocks, not the whole leaves. Returns the undo."""
    from repro_torch.optim import adamw

    real = adamw.whole_leaf_counts

    def wrong(params, leaf_axes, mesh):
        return [p.numel() for p in params] if rank == 1 else real(params, leaf_axes, mesh)

    adamw.whole_leaf_counts = wrong
    return lambda: setattr(adamw, "whole_leaf_counts", real)


def _plant_o_rows(rank: int):
    """Global rank 1 cuts MLA's o one head below its own block of rows
    (heads the model ranks do not divide, o gathered or held whole:
    ``Plan._mla_leaf``), so its heads' outputs meet another head's rows.
    Returns the undo."""
    from repro_torch.models import parallel

    real = parallel.Plan._mla_leaf

    def wrong(self, w, dim, mode, heads, width):
        if rank == 1 and dim == 0:
            heads = (heads[0] - 1, heads[1] - 1)
        return real(self, w, dim, mode, heads, width)

    parallel.Plan._mla_leaf = wrong
    return lambda: setattr(parallel.Plan, "_mla_leaf", real)


def _plant(rank: int, fault):
    """The undo of ``fault`` planted on global rank 1 (None: no fault)."""
    if not fault:
        return None
    if fault is True:
        return _nudge_one_rank(rank)
    if fault == "o_rows":
        return _plant_o_rows(rank)
    if fault == "books":
        return _plant_book_offset(rank)
    if fault == "ema":
        return _plant_ema_counts(rank)
    return _plant_mixer_fault(rank, fault)


def sharded_cases(rank, mesh, cases: dict) -> dict:
    """``sharded_train`` of each case in turn, on one process group."""
    return {name: sharded_train(rank, mesh, case) for name, case in cases.items()}


def train_and_serve(rank, mesh, train: dict, serve: dict) -> dict:
    """``sharded_train`` of each of ``train``'s cases, then
    ``sharded_serve`` of each of ``serve``'s, on one process group."""
    return {"train": sharded_cases(rank, mesh, train),
            "serve": {name: sharded_serve(rank, mesh, case) for name, case in serve.items()}}


def sharded_train(rank, mesh, case: dict):
    """``case``'s sharded training, twice from the same start: the steps'
    metrics, the parameters gathered whole, the local blocks' bits of the
    second run against the first, the replicas' agreement, and (with
    ``case["meter"]``) the step's traffic, its c10d bytes and the bytes of
    the rank's blocks."""
    if case.get("exact_f32"):
        exact_f32_attention()
    undo = _plant(rank, case.get("fault"))
    try:
        return _sharded_train(rank, mesh, case)
    finally:
        if undo is not None:
            undo()


def _sharded_train(rank, mesh, case: dict):
    import dataclasses

    from repro_torch.configs import TrainConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_guarded_train_step, make_train_step
    from repro_torch.models.convert import params_from_jax, reference_leaf_groups
    from repro_torch.models.model import param_axes
    from repro_torch.reduce import inspect

    cfg = dataclasses.replace(sharded_cfg(case["arch"], case["dtype"], case["kernels"]),
                              **case.get("cfg", {}))
    tcfg = TrainConfig(microbatches=case["micro"], **case.get("tcfg", {}))
    rules = getattr(SH, case["rules"])
    out = {"runs": []}
    for run in range(case.get("runs", 2)):
        whole = params_from_jax(case["params"], cfg)
        if case.get("gate") is not None:
            open_gates(whole, cfg, case["gate"])
        specs = SH.param_shardings(param_axes(cfg), mesh, rules, whole)
        params = SH.shard_tree(whole, specs, mesh)
        for p in R.tree_leaves(params):
            p.requires_grad_(True)
        opt = optim.init_state(params, fused_second_moment=tcfg.fused_second_moment,
                               leaf_groups=reference_leaf_groups(params, cfg))
        guard = case.get("guard")
        if guard:
            step = make_guarded_train_step(cfg, tcfg, mesh=mesh, param_shardings=specs)
            gstate = optim.init_guard_state(4)
        else:
            step = make_train_step(cfg, tcfg, mesh=mesh, param_shardings=specs)
        metrics, bits_after = [], []
        for i, tok in enumerate(case["tokens"]):
            batch = {"tokens": torch.from_numpy(tok)}
            if "ctx" in case:
                batch["image_embeds"] = torch.from_numpy(case["ctx"][i])
            if guard:
                batch["chaos_scale"] = torch.from_numpy(case["scales"][i])

                def go():
                    return step(params, opt, gstate, batch)
            else:
                def go():
                    return step(params, opt, batch)
            if case.get("meter") and i == 0:
                with C.traffic() as notes:
                    eqns = inspect.collective_eqns(lambda: out.setdefault("res", go()))
                res = out.pop("res")
                out["traffic"] = list(notes)
                out["c10d"] = [(n, a, b) for n, a, b in eqns]
            else:
                res = go()
            if guard:
                params, opt, gstate, m = res
            else:
                params, opt, m = res
            metrics.append({k: float(v) for k, v in m.items()})
            bits_after.append([p.detach().clone() for p in R.tree_leaves(params)])
        out["runs"].append({
            "metrics": metrics,
            "local": [p.detach().clone() for p in R.tree_leaves(params)],
            "bits_after": bits_after,
            "replicas_agree": _replicas_agree(params, specs, mesh),
        })
        if run == 0:
            out["whole"] = [SH.gather_whole(p.detach(), s, mesh)
                            for p, s in zip(R.tree_leaves(params), SH.tree_leaves(specs))]
            out["block_bytes"] = {
                "params": sum(p.numel() * p.element_size() for p in R.tree_leaves(params)),
                "moments": sum(t.numel() * t.element_size() for t in opt.m + opt.v),
                "accumulators": 4 * sum(p.numel() for p in R.tree_leaves(params))}
            if guard:
                out["guard"] = {"skipped": int(gstate.skipped), "filled": int(gstate.filled)}
    return out


# ------------------------------- sharded serving --------------------------------


def serving_cfg(case: dict):
    """The case's tiny config at f32 on the non-kernel route, with its
    ``n_kv_heads`` where the case sets one."""
    import dataclasses

    cfg = sharded_cfg(case["arch"], "float32", False)
    return dataclasses.replace(cfg, **case.get("cfg", {}))


def _bits_of(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int64 if t.element_size() == 8 else torch.int32) \
        if t.is_floating_point() else t


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits_of(a), _bits_of(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return a == b


def _clone(tree):
    from repro_torch.launch.sharding import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def serving_cases(rank, mesh, cases: dict, extra: dict) -> dict:
    """Every serving case in turn on one process group (``sharded_serve``),
    then ``extra``'s checks: the greedy merge on planted rows
    (``greedy_planted``) and ``launch.train.build(mesh=)`` (``build_step``)."""
    out = {name: sharded_serve(rank, mesh, case) for name, case in cases.items()}
    out["greedy_planted"] = greedy_planted(mesh, extra["greedy"])
    out["build_step"] = build_step(mesh, extra["build"])
    return out


def sharded_serve(rank, mesh, case: dict) -> dict:
    """``_sharded_serve`` with the attention's operand rounding off and
    ``case["fault"]`` planted on global rank 1 (``_plant_serving``)."""
    from repro_torch.models import attention

    saved = attention.bf16_round
    exact_f32_attention()
    undo = _plant_serving(rank, case.get("fault"))
    try:
        return _sharded_serve(mesh, case)
    finally:
        attention.bf16_round = saved
        if undo is not None:
            undo()


def _plant_serving(rank: int, fault):
    """A planted fault of sharded serving on global rank 1 (data 0, model
    1); returns the undo (None: no fault). Each moves one term, not every
    residual term of a rank alike (a nudged all-reduce, which the norms
    would cancel):

      True    the split-KV merge 2^-10 too large (a merge that desynced)
      ring    a ring cache cut by slots filled at global slot numbers
              (``fill_kv_cache``'s ``slot0`` taken as 0: the rank keeps
              rank 0's positions)
      mla     the latent merge's denominators 2^-10 too large
      ssm     the SSM decode's conv block read one channel off
      rec     the RG-LRU decode's ``h`` from its neighbour's channels (every
              rank gathers the blocks, so none waits)
      books   stream 0's greedy merge on the rank-local column index
              (every rank splits the streams alike, so none waits)
      o_rows  MLA's o cut one head off (``_plant_o_rows``)
    """
    from repro_torch.models import attention, parallel, rglru, ssm

    if not fault:
        return None
    if fault == "o_rows":
        return _plant_o_rows(rank)
    mine = rank == 1
    if fault in (True, "mla"):
        module, name = attention, "merge_decode_partials"
        real = module.merge_decode_partials
        if fault is True:
            def wrong(parts):
                return real(parts) * (1 + 2**-10) if mine else real(parts)
        else:
            def wrong(parts):
                return real([(m, d * (1 + 2**-10), o) for m, d, o in parts] if mine else parts)
    elif fault == "ring":
        module, name = attention, "fill_kv_cache"
        real = module.fill_kv_cache

        def wrong(cache, k, v, slot0=0):
            return real(cache, k, v, 0 if mine else slot0)
    elif fault == "ssm":
        module, name = ssm, "ssm_decode"
        real = module.ssm_decode

        def wrong(p, x_t, cache, cfg, **kw):
            if mine:
                cache = dict(cache, conv=torch.roll(cache["conv"], 1, -1))
            return real(p, x_t, cache, cfg, **kw)
    elif fault == "rec":
        module, name = rglru, "rglru_decode"
        real = module.rglru_decode

        def wrong(p, x_t, cache, cfg, tp=None, sv=None):
            blocks = sv.rows(cache["h"])
            if mine:
                cache = dict(cache, h=blocks[0])
            return real(p, x_t, cache, cfg, tp=tp, sv=sv)
    else:
        module, name = parallel.Plan, "greedy"
        real = module.greedy

        def wrong(self, logits):
            first, rest = logits[..., :1, :], logits[..., 1:, :]
            saved = self.vocab0
            if mine:
                self.vocab0 = 0
            try:
                tok = real(self, first)
            finally:
                self.vocab0 = saved
            return torch.cat([tok, real(self, rest)], -1)
    setattr(module, name, wrong)
    return lambda: setattr(module, name, real)


def _sharded_serve(mesh, case: dict) -> dict:
    """``case``'s sharded prefill and teacher-forced decode steps, run
    ``case["runs"]`` times from the same start: each run's prefill logits
    (the rank's rows), its caches gathered whole, and per step the logits
    and the greedy token of a retried step; the first step retried bitwise
    (logits and caches) from the caches before it; the replicated outputs'
    bits over the axes that hold them alike; with ``case["meter"]`` the first run's traffic notes
    and c10d ops of the prefill and of the first decode step, and the
    bytes of the rank's blocks."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import param_axes
    from repro_torch.reduce import inspect

    cfg = serving_cfg(case)
    rules = getattr(SH, case["rules"])
    whole = params_from_jax(case["params"], cfg)
    specs = SH.param_shardings(param_axes(cfg), mesh, rules, whole)
    params = SH.shard_tree(whole, specs, mesh)
    prefill_step = make_prefill_step(cfg, case["s_max"], mesh=mesh, param_shardings=specs)
    decode_logits = make_decode_step(cfg, greedy=False, mesh=mesh, param_shardings=specs)
    decode_greedy = make_decode_step(cfg, greedy=True, mesh=mesh, param_shardings=specs)
    prompts = torch.from_numpy(case["prompts"])
    ctx = torch.from_numpy(case["ctx"]) if "ctx" in case else None
    out = {"runs": []}

    def metered(name, fn):
        res = {}
        with C.traffic() as notes:
            eqns = inspect.collective_eqns(lambda: res.setdefault("r", fn()))
        out[f"{name}_traffic"] = list(notes)
        out[f"{name}_c10d"] = [(n, a, b) for n, a, b in eqns]
        return res["r"]

    for run in range(case.get("runs", 2)):
        meter = case.get("meter") and run == 0
        go = lambda: prefill_step(params, prompts, ctx)  # noqa: E731
        logits, caches = metered("prefill", go) if meter else go()
        # the specs of the global caches: a rank's block of slots need not
        # divide over "model" again (4 of 12 slots on 3 ranks)
        cspecs = _global_cache_specs(cfg, mesh, prompts.shape[0], case["s_max"])
        if meter:
            out["block_bytes"] = {
                "params": sum(p.numel() * p.element_size() for p in R.tree_leaves(params)),
                "caches": sum(t.numel() * t.element_size() for t in R.tree_leaves(caches)),
                "logits": logits.untyped_storage().nbytes()}
        res = {"prefill": logits.clone(),
               "caches": [SH.gather_whole(t, s, mesh).clone() for t, s in
                          zip(R.tree_leaves(caches), SH.tree_leaves(cspecs))],
               "steps": []}
        agree = bool(C.replica_bits_agree(logits, ("model",), mesh))
        pos = prompts.shape[1]
        for i, tok in enumerate(case["decode"]):
            tok = torch.from_numpy(tok)
            # each step from the committed caches: the recurrent ones are
            # new tensors a step, the KV caches' in-place write repeats
            before = _clone(caches)
            if i == 0:
                go = lambda: decode_logits(params, caches, tok, pos)  # noqa: E731
                lg, caches = metered("decode", go) if meter else go()
                after = _clone(caches)
                lg2, caches = decode_logits(params, _clone(before), tok, pos)  # the retry
                res["retry_bitwise"] = _same_bits(lg, lg2) and _same_bits(after, _clone(caches))
                res["retry_wrote"] = not _same_bits(before, after)
            else:
                lg, caches = decode_logits(params, caches, tok, pos)
            go = lambda: decode_greedy(params, _clone(before), tok, pos)  # noqa: E731
            nxt, _ = metered("greedy", go) if meter and i == 0 else go()
            agree &= bool(C.replica_bits_agree(lg, ("model",), mesh))
            agree &= bool(C.replica_bits_agree(nxt, ("model",), mesh))
            res["steps"].append({"logits": lg.clone(), "token": nxt.clone()})
            pos += 1
        for t, s in zip(R.tree_leaves(caches), SH.tree_leaves(cspecs)):
            held = tuple(ax for ax in mesh.axis_names if ax not in SH.spec_axes(s))
            if held:
                agree &= bool(C.replica_bits_agree(t, held, mesh))
        res["replicas_agree"] = agree
        out["runs"].append(res)
    return out


def _global_cache_specs(cfg, mesh, batch, s_max):
    from repro_torch.launch import sharding as SH
    from repro_torch.models import make_caches

    return SH.cache_shardings(make_caches(cfg, batch, s_max, torch.device("meta")), cfg, mesh)


def greedy_planted(mesh, case: dict) -> dict:
    """``Plan.greedy`` on planted rows of the whole (padded) vocabulary:
    each rank takes its columns; the merged token against ``torch.argmax``
    over each row's ``vocab_size`` columns."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import _serving
    from repro_torch.models.model import param_axes

    from repro_torch.models.model import init_params

    cfg = serving_cfg(case)
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, SH.TP_ONLY_RULES, meta)
    plan, _ = _serving(cfg, mesh, specs)(1, 8)
    rows = torch.from_numpy(case["rows"])  # (R, 1, padded vocab)
    n = rows.shape[-1] // mesh.axis_size("model")
    mine = rows[..., plan.vocab0:plan.vocab0 + n]
    return {"merged": plan.greedy(mine), "argmax": torch.argmax(rows[..., :cfg.vocab_size],
                                                                -1).to(torch.int32)}


def build_step(mesh, case: dict) -> dict:
    """``launch.train.build(mesh=, param_shardings=)`` against
    ``make_train_step(mesh=)``: one step each from the same blocks and
    batch, the losses' bits and the blocks after."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import param_axes

    exact_f32_attention()
    cfg = sharded_cfg(case["arch"], "float32", False)
    tcfg = TrainConfig()
    whole = params_from_jax(case["params"], cfg)
    specs = SH.param_shardings(param_axes(cfg), mesh, SH.DEFAULT_RULES, whole)
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    out = {}
    for name in ("build", "direct"):
        params = SH.shard_tree(whole, specs, mesh)
        if name == "build":
            params, opt, step = train_cli.build(cfg, tcfg, "cpu", params=params, mesh=mesh,
                                                param_shardings=specs)
        else:
            for p in R.tree_leaves(params):
                p.requires_grad_(True)
            opt = optim.init_state(params)
            step = make_train_step(cfg, tcfg, mesh=mesh, param_shardings=specs)
        params, opt, m = step(params, opt, batch)
        out[name] = {"loss": m["loss"].detach().clone(),
                     "params": [p.detach().clone() for p in R.tree_leaves(params)]}
    return out
