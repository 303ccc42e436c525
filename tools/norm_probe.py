#!/usr/bin/env python3
"""Probe of the row-norm kernel (K5a ``layernorm_np``, K5b ``rmsnorm``) on one GPU.

    python3 tools/norm_probe.py [--parent DIR]

Device time per call by the profiler (``chip_smoke.device_ms``; back-to-back
calls, so an input of up to ~40 MB stays in L2), each kernel checked against
its plain version before it is timed:

  before/after  with ``--parent DIR`` (a checkout of an earlier commit, e.g.
                ``git archive <commit> | tar -x -C DIR``): the earlier
                commit's norm kernel, built from DIR, and this tree's at
                4, 1024 and 2048 rows of 2048 bf16, in turns (earlier, this,
                this, earlier), beside ``F.layer_norm`` and ``F.rms_norm``.
                The earlier entry points are called with the signatures of
                the kernel before its redesign (an f32 gamma, cast per call).
  gamma         K5b with gamma in f32, bf16 and f16 at the same rows.
  routes        f32 and f16 input, a 2-byte offset base and d = 2050 (the
                element route), rows of 40000 (the re-read route).
  geometry      warps a row x rows a CTA for K5a at 4 to 2048 rows, through
                the C entry point with the geometry given explicitly.

Prints the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

D = 2048


def parent_library(parent: str) -> ctypes.CDLL:
    """Build the earlier checkout's kernel library (in its own process) and
    bind its norm entry points with their old signatures."""
    parent = os.path.abspath(parent)
    code = "from repro_torch.kernels import build; build.library()"
    subprocess.run([sys.executable, "-c", code], cwd=parent,
                   env=dict(os.environ, PYTHONPATH=os.path.join(parent, "src")), check=True)
    lib = ctypes.CDLL(glob.glob(os.path.join(parent, "build/repro_torch/*/libkernels.so"))[0])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rm_layernorm_np.argtypes = (p, p, i, i, f, i, p)
    lib.rm_rmsnorm.argtypes = (p, p, p, i, i, f, i, p)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time against")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build, layernorm_np, rmsnorm
    from repro_torch.kernels.row_moments import layernorm_np_plain, plan_for, rmsnorm_plain

    if not torch.cuda.is_available():
        print("norm_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    old = parent_library(args.parent) if args.parent else None
    new = build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def us(fn):
        return f"{cs.device_ms(fn, 'row_norm_kernel') * 1e3:.2f}"

    def both_agree(x, gamma):
        return (cs.bf16_ulp_ok(layernorm_np(x), layernorm_np_plain(x))
                and cs.bf16_ulp_ok(rmsnorm(x, gamma), rmsnorm_plain(x, gamma)))

    for rows in (4, 1024, 2048):
        x = (torch.randn((rows, D), generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
        gamma = (torch.rand((D,), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        cs.check(both_agree(x, gamma), f"the norms disagree with their plain versions at {rows}")
        t = {}
        if old is not None:
            out = torch.empty_like(x)
            stream = build.stream_ptr(x)

            def old_ln():
                return old.rm_layernorm_np(x.data_ptr(), out.data_ptr(), rows, D, 1e-5, 1, stream)

            def old_rn():  # the earlier wrapper cast gamma to f32 on every call
                g32 = gamma.to(torch.float32)
                return old.rm_rmsnorm(x.data_ptr(), g32.data_ptr(), out.data_ptr(), rows, D,
                                      1e-6, 1, stream)

            old_ln()
            torch.cuda.synchronize()
            cs.check(cs.bf16_ulp_ok(out, layernorm_np_plain(x)), "the earlier kernel disagrees")
        for turn in (("earlier", "this", "this", "earlier") if old is not None else ("this",)):
            if turn == "earlier":
                t.setdefault("earlier K5a", []).append(us(old_ln))
                t.setdefault("earlier K5b (its cast included)", []).append(
                    f"{cs.device_ms(old_rn) * 1e3:.2f}")
            else:
                t.setdefault("K5a", []).append(us(lambda: layernorm_np(x, 1e-5)))
                t.setdefault("K5b", []).append(us(lambda: rmsnorm(x, gamma, 1e-6)))
        t["F.layer_norm"] = [f"{cs.device_ms(lambda: F.layer_norm(x, (D,), eps=1e-5)) * 1e3:.2f}"]
        t["F.rms_norm"] = [f"{cs.device_ms(lambda: F.rms_norm(x, (D,), gamma, 1e-6)) * 1e3:.2f}"]
        for gdt in (torch.float32, torch.float16):
            g = gamma.to(gdt)
            t[f"K5b, {str(gdt)[6:]} gamma"] = [us(lambda: rmsnorm(x, g, 1e-6))]
        print(f"({rows}, {D}) bf16, {plan_for(x, gamma).name}; device us: "
              + "; ".join(f"{k} {' / '.join(v)}" for k, v in t.items()))

    for what, shape, dtype, off in (
            ("f32", (2048, D), torch.float32, 0), ("f16", (2048, D), torch.float16, 0),
            ("bf16 at a 2-byte offset", (1024, D), torch.bfloat16, 1),
            ("bf16", (1024, 2050), torch.bfloat16, 0), ("bf16", (64, 40000), torch.bfloat16, 0),
            ("f32", (64, 40000), torch.float32, 0)):
        n = shape[0] * shape[1]
        buf = (torch.randn((n + 8,), generator=gen, device="cuda") * 3 + 1).to(dtype)
        x = buf[off:off + n].view(shape)
        gamma = (torch.rand((shape[1],), generator=gen, device="cuda") + 0.5).to(dtype)
        cs.check(both_agree(x, gamma), f"the norms disagree at {shape} {what}")
        lib = cs.device_ms(lambda: F.layer_norm(x, (shape[1],), eps=1e-5))
        print(f"{shape} {what}, {plan_for(x, gamma).name}: K5a {us(lambda: layernorm_np(x))}, "
              f"K5b {us(lambda: rmsnorm(x, gamma))}, F.layer_norm {lib * 1e3:.2f} us")

    for rows in (4, 64, 256, 512, 1024, 2048):
        x = (torch.randn((rows, D), generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
        out = torch.empty_like(x)
        cells = []
        for warps, per_cta in ((1, 1), (1, 4), (1, 8), (2, 2), (4, 1), (8, 1)):
            chunks = D // 8 // (32 * warps)

            def call():
                return new.rm_layernorm_np(x.data_ptr(), out.data_ptr(), rows, D, 1e-5, 1, 0,
                                           warps, per_cta, chunks, 1, build.stream_ptr(x))

            cs.check(call() == 0, "launch refused")
            torch.cuda.synchronize()
            cs.check(cs.bf16_ulp_ok(out, layernorm_np_plain(x)), "a geometry disagrees")
            cells.append(f"{warps} warps/row x {per_cta} rows/CTA {us(call)}")
        print(f"K5a geometry at ({rows}, {D}) bf16 (the plan: {plan_for(x).name}), device us: "
              + ", ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
