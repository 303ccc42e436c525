#!/usr/bin/env python3
"""Probe of the collectives two ranks can run when they share one GPU.

    python3 tools/gloo_probe.py

1. gloo with CUDA tensors, two ranks on card 0, each operation in a
   spawn of its own (one that aborts its process fails only its spawn):
   all-gather (the values, then 400 MB rows a rank gathered as CUDA
   tensors, and the same rows copied to the host, gathered, and copied
   back), all-reduce (sum and max), and a batch of point-to-point sends
   and receives.
2. NCCL with two ranks on card 0: what it says.

Every rendezvous is on a free localhost port
(``repro_torch.launch.mesh.free_port``), so two checkouts may run the
probe at once. Prints the card's name and power limit (nvidia-smi), then
Python, torch and CUDA. Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.mesh import free_port  # noqa: E402

WORLD = 2
ROW = 1 << 20  # elements of the small row
BIG = 100 << 20  # elements of the 400 MB row


def _sync_time(fn) -> float:
    """Seconds of ``fn()``, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _all_gather(rank: int, dev: torch.device, x: torch.Tensor) -> None:
    outs = [torch.empty_like(x) for _ in range(WORLD)]
    dist.all_gather(outs, x)
    torch.cuda.synchronize()
    vals = [float(o[0]) for o in outs]
    big = torch.ones(BIG, device=dev)
    rows = [torch.empty_like(big) for _ in range(WORLD)]

    def staged():
        host = big.cpu()
        host_rows = [torch.empty_like(host) for _ in range(WORLD)]
        dist.all_gather(host_rows, host)
        return [r.to(dev) for r in host_rows]

    direct_s = [_sync_time(lambda: dist.all_gather(rows, big)) for _ in range(2)][-1]
    staged_s = [_sync_time(staged) for _ in range(2)][-1]
    print(f"rank {rank} all_gather ok values {vals}; 400MB direct {direct_s:.3f} s "
          f"staged {staged_s:.3f} s", flush=True)


def _all_reduce(rank: int, x: torch.Tensor) -> None:
    for name, op in (("", dist.ReduceOp.SUM), (" max", dist.ReduceOp.MAX)):
        y = x.clone()
        dist.all_reduce(y, op=op)
        torch.cuda.synchronize()
        print(f"rank {rank} all_reduce{name} ok {float(y[0])}", flush=True)


def _send_recv(rank: int, x: torch.Tensor) -> None:
    r = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % WORLD),
           dist.P2POp(dist.irecv, r, (rank - 1) % WORLD)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    torch.cuda.synchronize()
    print(f"rank {rank} send_recv ok {float(r[0])}", flush=True)


def op_run(rank: int, port: int, op: str) -> None:
    """One gloo rank on card 0 running ``op``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    dev = torch.device("cuda:0")
    x = torch.full((ROW,), float(rank + 1), device=dev)
    if op == "all_gather":
        _all_gather(rank, dev, x)
    elif op == "all_reduce":
        _all_reduce(rank, x)
    else:
        _send_recv(rank, x)
    dist.destroy_process_group()


def nccl_run(rank: int, port: int) -> None:
    """One NCCL rank on card 0: an all-reduce, or what NCCL says."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    x = torch.ones(4, device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"nccl rank {rank}: all_reduce ok {x.tolist()}", flush=True)
    except Exception as e:
        print(f"nccl rank {rank}: {type(e).__name__}: {str(e)[:300]}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          flush=True)
    for op in ("all_gather", "all_reduce", "send_recv"):
        try:
            mp.spawn(op_run, args=(free_port(), op), nprocs=WORLD)
        except Exception as e:
            print(f"{op}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=nccl_run, args=(r, port)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            print("nccl rank hung; killed")
        else:
            print("nccl exit", p.exitcode)


if __name__ == "__main__":
    main()
