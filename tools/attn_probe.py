#!/usr/bin/env python3
"""Probe of K6's wide variant (``csrc/flash_attention_wide.cu``, heads past 128) on one GPU.

    python3 tools/attn_probe.py [--parent DIR]

At recurrentgemma-9b's attention, 16 query heads on one kv head of 256,
bf16, causal: the ring case's prefill (4 x 2304 tokens, window 2048), the
training shape (4 x 512) and the serving prefill (4 x 256). Each kernel is
checked against ``flash_attention_plain`` (2 bf16 ulps + 2e-3) before it
is timed. Device time per call by the profiler (``chip_smoke.device_ms``,
back-to-back calls), beside the bound (``chip_smoke.bound_ms``: the
visible pairs' tensor-core work against q, k, v and o's bytes) and
PyTorch's attention (the window as a mask).

  before/after  with ``--parent DIR`` (a checkout of an earlier commit,
                e.g. ``git archive <commit> | tar -x -C DIR``, built in its
                own process): the earlier commit's ``fa_forward`` and this
                tree's, in turns (earlier, this, this, earlier), both through
                the C entry point with the same buffers.
  resources     registers a thread and spill bytes of the wide kernel's
                instantiations: ``nvcc -Xptxas -v`` on this tree's source
                alone (with its C75xx notes, if any), and ``cuobjdump
                --dump-resource-usage`` on the built library.

Prints the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

HQ, HKV, D = 16, 1, 256  # recurrentgemma-9b's heads
WINDOW = 2048
# label, batch, tokens, window
SHAPES = (("ring prefill", 4, 2304, WINDOW), ("training", 4, 512, None),
          ("serving prefill", 4, 256, None))
KERNEL = "attn_fwd_wide_kernel"


def parent_library(parent: str) -> ctypes.CDLL:
    """Build the earlier checkout's kernel library (in its own process) and
    bind its attention entry point."""
    parent = os.path.abspath(parent)
    code = "from repro_torch.kernels import build; build.library()"
    subprocess.run([sys.executable, "-c", code], cwd=parent,
                   env=dict(os.environ, PYTHONPATH=os.path.join(parent, "src")), check=True)
    lib = ctypes.CDLL(glob.glob(os.path.join(parent, "build/repro_torch/*/libkernels.so"))[0])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_forward.argtypes = (p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, i, p)
    lib.fa_forward.restype = i
    return lib


def start_ptxas_report(build) -> subprocess.Popen:
    """``nvcc -Xptxas -v`` of the wide source alone, started in the
    background (it runs beside the library's build)."""
    out = os.path.join(ROOT, "build", "attn_probe")
    os.makedirs(out, exist_ok=True)
    return subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(build.CSRC / "flash_attention_wide.cu"), "-o", os.path.join(out, "wide.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def print_resources(proc: subprocess.Popen, lib_path, nvcc: str) -> None:
    """The wide kernel's ptxas lines (registers, spills, C75xx notes) and
    its cuobjdump resource usage."""
    log, _ = proc.communicate()
    lines = log.splitlines()
    keep, take = [], False
    for line in lines:
        if "Compiling entry function" in line:
            take = KERNEL in line
        if take or re.search(r"C75\d\d", line):
            keep.append(line)
    print("ptxas -v, flash_attention_wide.cu (sm_90a):")
    for line in keep or lines:
        print("   ", line)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", "\n".join(keep))]
    print(f"    spill bytes (stores + loads, every instantiation): {sum(spills)}")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib_path)],
                         capture_output=True, text=True)
    print("cuobjdump --dump-resource-usage, the library's wide kernel:")
    text = res.stdout.splitlines()
    for n, line in enumerate(text):
        if KERNEL in line:
            print("   ", line.strip())
            if n + 1 < len(text):
                print("   ", text[n + 1].strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time against")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import LOG2E

    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ptxas = start_ptxas_report(build)
    old = parent_library(args.parent) if args.parent else None
    new = build.library()
    print_resources(ptxas, build.build(), build.nvcc())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def agrees(out, want) -> bool:
        return bool(torch.isfinite(out.float()).all()) and bool(torch.all(
            (out.float() - want.float()).abs() <= 2.0**-6 * want.float().abs() + 2e-3))

    for label, b, s, window in SHAPES:
        q = (torch.randn((b, HQ, s, D), generator=gen, device="cuda") * 0.5).bfloat16()
        k = (torch.randn((b, HKV, s, D), generator=gen, device="cuda") * 0.5).bfloat16()
        v = (torch.randn((b, HKV, s, D), generator=gen, device="cuda") * 0.5).bfloat16()
        kw = dict(causal=True, window=window)
        want = flash_attention_plain(q, k, v, **kw)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        cs.check(agrees(got, want), f"this tree's kernel disagrees with the plain version at "
                 f"{label}")
        out = torch.empty_like(q)

        def call(lib):
            return lambda: lib.fa_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * HQ, s, s, D, HQ,
                HKV, D**-0.5 * LOG2E, 1, -1 if window is None else window, 0, s, 1,
                build.stream_ptr(q))

        for turn, lib in (("earlier", old), ("this", new)):
            if lib is not None:
                out.zero_()
                cs.check(call(lib)() == 0, f"{turn}: the launch was refused")
                torch.cuda.synchronize()
                cs.check(agrees(out, want), f"{turn}: the entry point disagrees at {label}")
        pairs = cs._causal_pairs(s, s, 0, window) * b * HQ
        bound, by = cs.bound_ms((2 * q.numel() + 2 * k.numel()) * 2,
                                tensor_flops=4 * D * pairs, core_flops=pairs)
        t: dict = {}
        for turn in (("earlier", "this", "this", "earlier") if old is not None else ("this",)):
            t.setdefault(turn, []).append(
                cs.device_ms(call(old if turn == "earlier" else new), KERNEL) * 1e3)
        sdpa = (cs._sdpa_window(q, k, v, window) if window is not None
                else cs._sdpa_gqa(q, k, v))
        lib_us = cs.device_ms(
            (lambda: cs._sdpa_window(q, k, v, window)) if window is not None
            else (lambda: cs._sdpa_gqa(q, k, v))) * 1e3
        call_us = cs.time_ms(lambda: flash_attention(q, k, v, **kw), iters=20) * 1e3
        speed = ""
        if old is not None:
            before = sum(t["earlier"]) / len(t["earlier"])
            after = sum(t["this"]) / len(t["this"])
            speed = f"; earlier / this {before / after:.3f}x"
        print(f"{label} ({b} x {HQ} q / {HKV} kv x {s} x {D} bf16, causal"
              f"{'' if window is None else f', window {window}'}; {pairs} visible pairs): "
              f"max_abs_err {err:.3g} vs plain; device us: "
              + "; ".join(f"{k_} {' / '.join(f'{x:.2f}' for x in v_)}" for k_, v_ in t.items())
              + f"; this tree's whole call {call_us:.2f}; SDPA {lib_us:.2f} (max |d| "
              f"{float((sdpa.float() - got.float()).abs().max()):.3g}); bound "
              f"{bound * 1e3:.2f} by {by}" + speed
              + f"; roofline share {bound * 1e3 / min(t['this']):.3f}")
        del q, k, v, out, want, got, sdpa
        torch.cuda.empty_cache()
    print(f"bound rates: {cs.HBM_BYTES_PER_S / 1e12:.2f} TB/s of HBM, "
          f"{cs.BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s bf16 on the tensor cores")
    return 0


if __name__ == "__main__":
    sys.exit(main())
