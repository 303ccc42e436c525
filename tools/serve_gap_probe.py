#!/usr/bin/env python3
"""Where the sharded serving steps' logit gap to the single rank comes from, on one GPU.

    python3 tools/serve_gap_probe.py [--archs granite-moe-1b-a400m deepseek-7b] [--steps 16]

``chip_smoke.py``'s sharded serving phase holds the logits of four gloo
ranks sharing the card on (data 2, model 2) against the single rank's, on
the same bf16 weights and teacher-forced tokens. This probe runs the same
weights (seed 0, full width and depth), prompts (4 x 256, seed 2) and
rules (deepseek-7b TP_ONLY_RULES, granite-moe-1b-a400m SMALL_MODEL_RULES)
four ways:

  single bf16    the single rank on the kernels, as the phase runs it; its
                 greedy tokens are every other route's decode inputs;
  single f32     the same parameter values upcast to f32, on the non-kernel
                 route with the attention's bf16 operand rounding off: the
                 reference;
  sharded bf16   the four ranks, as the phase runs them;
  sharded f32    the four ranks at f32, as the single f32 route.

For each arch it prints the largest gap (max |a - b| over max |b| of one
tensor of logits: the prefill's last token or one decode step's) of
sharded bf16 against single bf16 (the phase's figure), of each bf16 route
against single f32, and of sharded f32 against single f32. With a MoE it
also prints the router's flips: the share of (token, layer) whose top-k
expert set differs between the sharded and the single route, at bf16 and
at f32, in the prefill and in the decode steps, and the first layer with
one. Prints the card's name and power limit first. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import reduce as R  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import param_axes  # noqa: E402

RULES = {"granite-moe-1b-a400m": "SMALL_MODEL_RULES", "deepseek-7b": "TP_ONLY_RULES"}
SLOTS, PROMPT, PARAM_SEED, PROMPT_SEED = 4, 256, 0, 2
SHAPE, AXES, WORLD = (2, 2), ("data", "model"), 4


def route_cfg(cfg, f32: bool):
    """The bf16 route as the phase runs it, or the f32 reference route."""
    if not f32:
        return cfg
    return dataclasses.replace(cfg, dtype="float32", use_kernels=False, mma_reductions=False)


def routed(fn):
    """``fn()`` with every ``moe.route`` call's top-k experts (sorted) kept:
    (fn's result, the list of (B, S, k) int tensors on the host)."""
    seen, real = [], MOE.route

    def spy(p, x, cfg, gate_hook=None):
        r = real(p, x, cfg, gate_hook)
        seen.append(torch.sort(r.expert_ix, -1).values.cpu())
        return r

    MOE.route = spy
    try:
        return fn(), seen
    finally:
        MOE.route = real


def upcast(params, f32: bool):
    """The parameters' values in f32 (the f32 route), or as they are."""
    if not f32:
        return params
    return SH.tree_map(lambda t: t.float() if t.is_floating_point() else t, params)


def drawn(cfg, dev):
    """The phase's seeded bf16 parameters, whole."""
    return init_params(cfg, torch.Generator(device=dev).manual_seed(PARAM_SEED), dev)


def route_setup(f32: bool):
    """The process's settings of a route: the bf16 route on the paper's
    fused reductions (``cuda_fused``, as the phase runs), the f32 route on
    the plain ones with the attention's bf16 operand rounding off."""
    R.set_default_backend(None if f32 else "cuda_fused")
    A.bf16_round = (lambda x: x) if f32 else REAL_ROUND


REAL_ROUND = A.bf16_round


def serve(cfg, params, prompts, tokens, steps, prefill, decode):
    """The prefill's logits and ``steps`` teacher-forced decode steps'
    logits (the single bf16 route's own greedy tokens when ``tokens`` is
    None): (logits list on the host, tokens)."""
    own = tokens is None
    tokens = [] if own else tokens
    with torch.no_grad():
        lg, caches = prefill(params, prompts)
        out = [lg.float().cpu()]
        for i in range(steps):
            if own:
                tokens.append(torch.argmax(out[-1], -1).to(torch.int32))
            lg, caches = decode(params, caches, tokens[i].to(prompts.device), PROMPT + i)
            out.append(lg.float().cpu())
    return out, tokens


def single(arch: str, steps: int, path: str) -> None:
    """The single rank's two routes, saved to ``path``."""
    dev = torch.device("cuda")
    res, tokens = {}, None
    prompts = torch.randint(0, get_arch(arch).vocab_size, (SLOTS, PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(PROMPT_SEED),
                            device=dev)
    for f32 in (False, True):
        cfg = route_cfg(get_arch(arch), f32)
        params = upcast(drawn(get_arch(arch), dev), f32)
        route_setup(f32)
        (logits, toks), flips = routed(lambda: serve(
            cfg, params, prompts, tokens, steps, make_prefill_step(cfg, PROMPT + steps),
            make_decode_step(cfg, greedy=False)))
        tokens = toks
        res["f32" if f32 else "bf16"] = {"logits": logits, "experts": flips}
        del params
        torch.cuda.empty_cache()
    route_setup(False)
    torch.save(dict(res, prompts=prompts.cpu(), tokens=tokens), path)


def rank_main(rank: int, arch: str, steps: int, port: int, path: str, out: str) -> None:
    """One of the four ranks: both routes, its rows' logits and experts."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_process_group("cuda")
    try:
        mesh = mesh_lib.make_mesh(SHAPE, AXES)
        ref = torch.load(path)
        dev = mesh.device
        prompts = ref["prompts"].to(dev)
        res = {}
        for f32 in (False, True):
            base = get_arch(arch)
            cfg = route_cfg(base, f32)
            meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
            specs = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, RULES[arch]), meta)
            for r in range(WORLD):  # one whole model on the card at a time
                if r == rank:
                    params = SH.shard_tree(drawn(base, dev), specs, mesh)
                    params = upcast(params, f32)
                    torch.cuda.empty_cache()
                dist.barrier()
            route_setup(f32)
            (logits, _), flips = routed(lambda: serve(
                cfg, params, prompts, ref["tokens"], steps,
                make_prefill_step(cfg, PROMPT + steps, mesh=mesh, param_shardings=specs),
                make_decode_step(cfg, greedy=False, mesh=mesh, param_shardings=specs)))
            res["f32" if f32 else "bf16"] = {"logits": logits, "experts": flips}
            del params
            torch.cuda.empty_cache()
        if mesh.axis_index("model") == 0:
            torch.save(dict(res, data=mesh.axis_index("data")), out.format(rank))
    finally:
        mesh_lib.shutdown(barrier=False)


def gap(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max() / y.double().abs().max())
               for x, y in zip(a, b))


def flip_share(mine: list, want: list, rows: slice, n_layers: int, steps: int) -> dict:
    """The share of (token, layer) whose expert set differs: the prefill's
    calls (the first ``n_layers``) and the decode steps' (the rest)."""
    def share(calls):
        diff = sum(int((m != w[rows]).any(-1).sum()) for m, w in calls)
        return diff / max(1, sum(m.shape[0] * m.shape[1] for m, _ in calls))

    pairs = list(zip(mine, want))
    first = next((i % n_layers for i, (m, w) in enumerate(pairs) if (m != w[rows]).any()), None)
    return {"prefill": share(pairs[:n_layers]), "decode": share(pairs[n_layers:]),
            "first_layer": first}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(RULES))
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.launch.mesh import free_port

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for arch in args.archs:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            path, out = os.path.join(tmp, "single.pt"), os.path.join(tmp, "rank{}.pt")
            single(arch, args.steps, path)
            torch.cuda.empty_cache()
            mp.spawn(rank_main, args=(arch, args.steps, free_port(), path, out), nprocs=WORLD)
            ref = torch.load(path)
            ranks = [torch.load(out.format(r)) for r in (0, 2)]
        cfg = get_arch(arch)
        n = SLOTS // SHAPE[0]
        rows = [slice(r["data"] * n, (r["data"] + 1) * n) for r in ranks]

        def worst(route, against):
            return max(gap(r[route]["logits"], [t[rw] for t in ref[against]["logits"]])
                       for r, rw in zip(ranks, rows))

        single_bf16 = gap(ref["bf16"]["logits"], ref["f32"]["logits"])
        print(f"{arch} ({RULES[arch]}, {cfg.n_layers} layers, {SLOTS} x {PROMPT} prompts, "
              f"{args.steps} decode steps): sharded bf16 vs single bf16 "
              f"{worst('bf16', 'bf16'):.4g}; against single f32: single bf16 "
              f"{single_bf16:.4g}, sharded bf16 {worst('bf16', 'f32'):.4g}; sharded f32 vs "
              f"single f32 {worst('f32', 'f32'):.4g}", flush=True)
        if cfg.moe is not None:
            for route in ("bf16", "f32"):
                for r, rw in zip(ranks, rows):
                    f = flip_share(r[route]["experts"], ref[route]["experts"], rw, cfg.n_layers,
                                   args.steps)
                    print(f"{arch} router flips, sharded vs single {route}, rows {rw.start}-"
                          f"{rw.stop - 1}: prefill {f['prefill']:.4%} of (token, layer), decode "
                          f"{f['decode']:.4%}, first at layer {f['first_layer']}", flush=True)
            f = flip_share(ref["bf16"]["experts"], ref["f32"]["experts"], slice(None),
                           cfg.n_layers, args.steps)
            print(f"{arch} router flips, single bf16 vs single f32: prefill {f['prefill']:.4%}, "
                  f"decode {f['decode']:.4%}, first at layer {f['first_layer']}", flush=True)


if __name__ == "__main__":
    main()
