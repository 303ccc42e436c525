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
