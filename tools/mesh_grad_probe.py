#!/usr/bin/env python3
"""Probe of the data mesh's gradients against the single rank's on one GPU.

    python3 tools/mesh_grad_probe.py

olmo-1b at full width and depth, the training CLI's seeded parameters and
its first global batch (4 x 512, ``SyntheticLM`` at the config's seed),
through ``launch.steps.make_grads_fn``, the gradient function of both
training steps:

  single   the gradients over the 4 rows (the single-rank guarded step);
  mesh     the gradients over rows 0-1 and over rows 2-3, summed in rank
           order and halved, as ``make_mesh_guarded_train_step``'s
           fixed-order combine does on two ranks (one process here: the
           sum is the same f32 arithmetic);
  f32      the same two, from the same parameter values upcast to f32 and
           run in f32 on the non-kernel route: the reference both are held
           against, and the check that splitting the rows is exact math.

Prints the losses of all rows and of each half, the global norms, each
route's distance to the f32 reference (the norm of the difference over the
reference's norm), and the leaves where
the single and the mesh norms differ most, with each one's norms and
distances. Prints the card's name and power limit first. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import reduce as R  # noqa: E402
from repro_torch.configs import TrainConfig, get_arch  # noqa: E402
from repro_torch.data import ShardInfo, SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.steps import make_grads_fn  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

TOP = 8  # leaves listed


def leaf_names(tree, prefix: str = "") -> list:
    """Names of ``reduce.tree_leaves(tree)``'s leaves, in its order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [n for i, sub in enumerate(tree) for n in leaf_names(sub, f"{prefix}[{i}]")]


def norm(leaves) -> float:
    return float(torch.stack([g.double().square().sum() for g in leaves]).sum().sqrt())


def dist(a, b) -> float:
    return float(torch.stack([(x.double() - y.double()).square().sum()
                              for x, y in zip(a, b)]).sum().sqrt())


def single_and_mesh(cfg, params, tokens):
    """(the gradients over all rows, the two halves' gradients combined,
    the losses of all rows, of rows 0-1 and of rows 2-3)."""
    grads = make_grads_fn(cfg, TrainConfig())
    single, loss = grads(params, {"tokens": tokens})
    mesh, loss0 = grads(params, {"tokens": tokens[:2]})
    other, loss1 = grads(params, {"tokens": tokens[2:]})
    for a, b in zip(mesh, other):
        a.add_(b).div_(2)  # rank order: g[0] + g[1], then / world
    del other
    return single, mesh, [float(x) for x in (loss, loss0, loss1)]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    dev = torch.device("cuda")
    cfg, tcfg = get_arch("olmo-1b"), TrainConfig()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(tcfg.seed), dev)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    data = SyntheticLM(cfg.vocab_size, 512, 4, ShardInfo(), seed=tcfg.seed)
    tokens = torch.from_numpy(data.next()["tokens"]).to(dev)
    names = leaf_names(params)
    single, mesh, losses = single_and_mesh(cfg, params, tokens)
    print(f"loss over rows 0-3 {losses[0]!r}, rows 0-1 {losses[1]!r}, rows 2-3 {losses[2]!r}")

    cfg32 = dataclasses.replace(cfg, dtype="float32", use_kernels=False)
    params32 = _upcast(params)
    del params
    torch.cuda.empty_cache()
    ref, ref_mesh, _ = single_and_mesh(cfg32, params32, tokens)
    del params32
    torch.cuda.empty_cache()

    n_ref = norm(ref)
    print(f"global grad norm: single {norm(single)!r}, mesh {norm(mesh)!r}, f32 {n_ref!r}, "
          f"f32 split {norm(ref_mesh)!r}")
    print(f"distance to f32 (over its norm): single {dist(single, ref) / n_ref:.3e}, mesh "
          f"{dist(mesh, ref) / n_ref:.3e}, f32 split {dist(ref_mesh, ref) / n_ref:.3e}; single "
          f"to mesh {dist(single, mesh) / n_ref:.3e}")
    gaps = sorted(range(len(names)), key=lambda i: -abs(norm([single[i]]) - norm([mesh[i]])))
    for i in gaps[:TOP]:
        r = norm([ref[i]])
        print(f"{names[i]} {tuple(ref[i].shape)}: norm single {norm([single[i]]):.6g}, mesh "
              f"{norm([mesh[i]]):.6g}, f32 {r:.6g}; distance to f32 single "
              f"{dist([single[i]], [ref[i]]) / r:.3e}, mesh {dist([mesh[i]], [ref[i]]) / r:.3e}")


def _upcast(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().requires_grad_(True)
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return type(tree)(_upcast(v) for v in tree)


if __name__ == "__main__":
    main()
