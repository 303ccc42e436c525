"""Meshes, and the process group of a data-parallel launch.

Port of ``repro/launch/mesh.py``'s ``make_data_mesh``, ``make_host_mesh``
and ``batch_axes``; ``make_production_mesh`` (the TPU pod shapes) waits
for the ROADMAP's sharding item. A rank is one process: ``torchrun``
(``python -m torch.distributed.run``) or ``torch.multiprocessing.spawn``
starts them, and ``init_process_group`` below reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``), world 1 when
they are absent.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
      --tiny --guard --mesh --device cpu

The transport follows the devices and is chosen explicitly
(``choose_backend``) and printed: gloo for CPU ranks and for several ranks
that share one card, NCCL where each rank has a card of its own (world 1
on a card included). NCCL refuses two ranks on one GPU ("Duplicate GPU
detected"), so such a request is refused here with that reason, never
moved to gloo. A rank's device is ``cuda:{LOCAL_RANK % device_count}``
unless the caller asks for the CPU.

The meshes are ``core.collectives.Mesh`` objects of the port's own: named
axes mapped onto process groups (the whole world for an axis that spans
it, none for an axis of one rank), carrying the transport that was chosen
at set-up.
"""

from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.collectives import Mesh

# The process group's device and transport, set by init_process_group.
_STATE: dict = {}


def rank_env() -> tuple:
    """``(rank, world, local_rank, local_world)`` from the launcher's
    environment; world 1 when it sets none."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if not 0 <= rank < world:
        raise ValueError(f"RANK {rank} is outside WORLD_SIZE {world}")
    return rank, world, local_rank, local_world


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The rank's device: ``device`` where given (a bare "cuda" gets the
    rank's card), else the card ``LOCAL_RANK % device_count``; a card
    requested with none present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the ranks run on the GPU unless "
                           "given device='cpu'")
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def ranks_per_card(local_world: int) -> int:
    """Ranks of this host that share one card."""
    return -(-local_world // max(torch.cuda.device_count(), 1))


def choose_backend(device: torch.device, local_world: int, backend: str | None = None) -> str:
    """gloo for CPU ranks and for ranks that share a card, NCCL where each
    rank has a card of its own; a request NCCL cannot serve raises."""
    if device.type != "cuda":
        if backend not in (None, "gloo"):
            raise ValueError(f"the {backend} transport needs ranks on cards; CPU ranks use gloo")
        return "gloo"
    shared = ranks_per_card(local_world) > 1
    if backend is None:
        return "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError(
            f"NCCL refuses two ranks on one GPU (\"Duplicate GPU detected\"): {local_world} "
            f"ranks on {torch.cuda.device_count()} card(s); ranks that share a card use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown transport {backend!r}; expected 'nccl' or 'gloo'")
    return backend


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device=None, *, backend: str | None = None, init_method=None):
    """Join (or, at world 1 with no launcher, form) the process group:
    ``(rank, world, device, backend)``. The rendezvous is ``init_method``
    where given (e.g. ``file://...``), else the launcher's ``MASTER_ADDR``
    and ``MASTER_PORT`` (``tcp://localhost`` on a free port at world 1
    without them). Prints the rank, its device and the transport."""
    rank, world, local_rank, local_world = rank_env()
    dev = rank_device(device, local_rank)
    be = choose_backend(dev, local_world, backend)
    if not dist.is_initialized():
        if init_method is not None:
            init = init_method
        elif "MASTER_ADDR" in os.environ:
            init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        elif world == 1:
            init = f"tcp://localhost:{free_port()}"
        else:
            raise RuntimeError("WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT (torchrun "
                               "sets them)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(be, init_method=init, world_size=world, rank=rank)
    elif dist.get_backend() != be:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {be}")
    _STATE.update(device=dev, backend=be)
    staged = ", point-to-point through host buffers" if make_data_mesh().p2p_through_host else ""
    print(f"mesh: rank {rank} of {world} on {dev}, transport {be}{staged}", flush=True)
    return rank, world, dev, be


def shutdown(barrier: bool = True) -> None:
    """Leave the process group, after a barrier (so no rank leaves while
    another still sends) unless ``barrier`` is False: a rank that failed
    leaves at once, and the launcher ends the others."""
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()
    _STATE.clear()


def _mesh(shape: tuple, axis_names: tuple) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_process_group() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the world "
                         f"has {world}")
    groups = {}
    for name, size in zip(axis_names, shape):
        if size not in (1, world):
            raise NotImplementedError(
                f"axis {name!r} of {size} ranks in a world of {world}: meshes whose axes "
                "split the world (make_production_mesh) wait for the ROADMAP's sharding item")
        # a one-rank axis has no group: its gather is its own row
        groups[name] = dist.group.WORLD if size == world else None
    dev, be = _STATE["device"], _STATE["backend"]
    return Mesh(shape=tuple(shape), axis_names=tuple(axis_names), rank=rank, groups=groups,
                backend=be, device=dev)


def make_data_mesh(n: int | None = None) -> Mesh:
    """The pure data-parallel 1-D mesh, axis "data", over every rank (each
    rank one shard of the batch; the axis is the fixed-order combine's fold
    order). ``n`` must be the world size when given: a rank is a process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and int(n) != world:
        raise ValueError(f"a data mesh of {n} needs {n} ranks; the world has {world}")
    return _mesh((world,), ("data",))


def make_host_mesh(max_devices: int | None = None) -> Mesh:
    """The degenerate (1, n) mesh, axes ("data", "model"), over the ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if max_devices is None else int(max_devices)
    return _mesh((1, n), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes the global batch is split over (the data-parallel ones)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
