#!/usr/bin/env python3
"""Probe of the segmented gather (K8) and the fused sum (K1) on one GPU.

    python3 tools/reduce_probe.py [--parent DIR]

Device time per call by the profiler (``chip_smoke.device_ms``), every
kernel called through its C entry point with the same arguments and
buffers, beside the PyTorch call that computes the same function:

  before/after  with ``--parent DIR`` (a checkout of an earlier commit, e.g.
                ``git archive <commit> | tar -x -C DIR``): the earlier
                commit's ``segmented_gather.cu``, ``fused_reduce.cu``,
                ``fused_kahan.cu`` and ``tile_partials.cu``, built from DIR
                into one library, and this tree's, in turns (earlier, this,
                this, earlier): K8 over 2^28 values in 2048 packed segments
                (f32 and bf16 input, bf16 compute; ``torch.segment_reduce``),
                K1 at the token sum (4 x 512 f32) and at 2^26 bf16 and 2^28
                f32 (``torch.sum``), and the controls K2 (moments), K3
                (Kahan) and K10 (one level of the hierarchy) at 2^28 f32.
                The new K8 must be bitwise the earlier one at bf16 compute
                (the same ones-MMA operands), K1 and K2 bitwise at one lane.
  lanes         K8 at 2^28 bf16 over 132 to 2112 lanes.
  stream        K8 built without its last CTA's fold over the lanes (each
                tree's), at 2^28 f32 and bf16: the stream alone.
  registers     ``ptxas -v`` of this tree's two sources: the most registers
                and any spill of each kernel (the whole listing goes to
                chiprun_out/reduce_probe_ptxas.txt).

Prints the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PROBE_SOURCES = ("segmented_gather.cu", "fused_reduce.cu", "fused_kahan.cu", "tile_partials.cu")
OUT_DIR = os.path.join(ROOT, "build", "reduce_probe")


def build_library(csrc: str, name: str, sources=PROBE_SOURCES, flags=()) -> ctypes.CDLL:
    """``sources`` of ``csrc`` into one shared library (one nvcc each, in
    parallel), bound with this tree's signatures (unchanged since the
    parent)."""
    from repro_torch.kernels import build

    os.makedirs(OUT_DIR, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = os.path.join(OUT_DIR, f"{name}_{src}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-c", os.path.join(csrc, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, proc in zip(sources, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        logs.append(log)
    lib_path = os.path.join(OUT_DIR, f"lib{name}.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-shared", *objs, "-o", lib_path],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.ptxas_log = "\n".join(logs)
    return lib


def without_last_fold(csrc: str, name: str) -> str:
    """A copy of ``csrc`` whose K8 returns after the ticket: every CTA
    streams its lane and flushes, and no CTA folds the lanes (the output is
    not the sum; only its time is read)."""
    out = os.path.join(OUT_DIR, f"{name}_stream_csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "segmented_gather.cu")
    text = open(path).read()
    if "  if (!am_last) return;" not in text:
        raise RuntimeError("the gather's last-CTA test moved: update without_last_fold")
    with open(path, "w") as f:
        f.write(text.replace("  if (!am_last) return;", "  return;"))
    return out


def registers(log: str) -> list:
    """(kernel, most registers, spill lines) per kernel name in a ptxas -v
    listing."""
    worst: dict = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or re.search(
            r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            continue
        kernel = next((k for k in ("segments_kernel", "fused_sum_kernel", "fused_kahan_kernel",
                                   "tile_partials_kernel") if current and k in current), None)
        if kernel is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs, spills = worst.get(kernel, (0, 0))
            worst[kernel] = (max(regs, int(m.group(1))), spills)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            regs, spills = worst.get(kernel, (0, 0))
            worst[kernel] = (regs, spills + 1)
    return [(k, r, s) for k, (r, s) in sorted(worst.items())]


class Calls:
    """Closures that launch one library's kernels on fixed inputs and
    buffers (a ticket of the library's own)."""

    def __init__(self, lib, torch, offsets):
        self.lib, self.torch, self.offsets = lib, torch, offsets
        self.ticket = torch.zeros((1,), dtype=torch.int32, device="cuda")
        self.ops = np.zeros((1,), np.int32)  # an empty epilogue chain
        self.params = np.zeros((1,), np.float32)
        self.chain = (0, self.ops.ctypes.data, self.params.ctypes.data,
                      self.params.ctypes.data)

    def _check(self, err, what):
        if err:
            raise RuntimeError(f"{what}: cudaError {err}")

    def segments(self, x, lanes, compute):
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        tcounts, maps, t, c, tpl = ops._cover_maps(self.offsets, lanes)
        dmaps = ops._device_maps(self.offsets, lanes, "cuda")
        nseg = len(self.offsets) - 1
        sub = self.torch.empty((c, nseg), dtype=self.torch.float32, device="cuda")
        out = self.torch.empty((nseg,), dtype=self.torch.float32, device="cuda")
        stream = build.stream_ptr(out)

        def call():
            self._check(self.lib.sg_segments(
                x.data_ptr(), x.numel(), build.dtype_code(x), build.DTYPE_CODES[compute], 0, 0,
                dmaps.data_ptr(), maps.shape[1], c, nseg, int(x.data_ptr() % 16 == 0),
                *self.chain, sub.data_ptr(), out.data_ptr(), self.ticket.data_ptr(), stream),
                "sg_segments")
            return out

        return call

    def fused(self, x, lanes, compute, moments=False):
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        n = x.numel()
        r, c, _, _ = ops.lane_geometry(n, lanes)
        blocks = -(-max(1, -(-n // ops.TILE)) // r)
        out = self.torch.empty((2,), dtype=self.torch.float32, device="cuda")
        scratch = self.torch.empty((2 * c,), dtype=self.torch.int32, device="cuda")
        stream = build.stream_ptr(out)
        aligned = int(x.data_ptr() % 16 == 0)

        def call():
            if moments:
                err = self.lib.fr_moments(
                    x.data_ptr(), n, build.dtype_code(x), build.DTYPE_CODES[compute],
                    r * ops.TILE, blocks, c, aligned, out.data_ptr(), scratch.data_ptr(),
                    self.ticket.data_ptr(), stream)
            else:
                err = self.lib.fr_sum(
                    x.data_ptr(), n, build.dtype_code(x), build.DTYPE_CODES[compute], 0, 0,
                    r * ops.TILE, blocks, c, aligned, *self.chain, out.data_ptr(),
                    scratch.data_ptr(), self.ticket.data_ptr(), stream)
            self._check(err, "fr_sum")
            return out[:2] if moments else out[:1]

        return call

    def kahan(self, x, lanes, compute):
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        n = x.numel()
        r, c, bpl, _ = ops.lane_geometry(n, lanes)
        blocks = -(-max(1, -(-n // ops.TILE)) // r)
        out = self.torch.empty((1,), dtype=self.torch.float32, device="cuda")
        part = self.torch.empty((c, 2, ops.MXU), dtype=self.torch.float32, device="cuda")
        stream = build.stream_ptr(out)

        def call():
            self._check(self.lib.fk_sum(
                x.data_ptr(), n, build.dtype_code(x), build.DTYPE_CODES[compute], 0, r, blocks,
                bpl, c, int(x.data_ptr() % 16 == 0), *self.chain, out.data_ptr(),
                part.data_ptr(), self.ticket.data_ptr(), stream), "fk_sum")
            return out

        return call

    def level(self, x, compute):
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        n = x.numel()
        t, r, blocks, tpad = ops.tile_geometry(n)
        out = self.torch.empty((tpad,), dtype=self.torch.float32, device="cuda")
        stream = build.stream_ptr(out)

        def call():
            self._check(self.lib.tp_level(
                x.data_ptr(), n, 1, build.dtype_code(x), build.DTYPE_CODES[compute], 0, r,
                blocks, int(x.data_ptr() % 16 == 0), *self.chain, out.data_ptr(), stream),
                "tp_level")
            return out

        return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time against")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mma_reduce import default_num_lanes
    from repro_torch.launch.reduce_demo import packed_offsets

    if not torch.cuda.is_available():
        print("reduce_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    jobs = {"this": (str(build.CSRC), "this", PROBE_SOURCES, ("-Xptxas", "-v"))}
    if args.parent:
        jobs["earlier"] = (os.path.join(os.path.abspath(args.parent),
                                        "src/repro_torch/kernels/csrc"), "earlier",
                           PROBE_SOURCES, ())
    for name in [k for k in ("this", "earlier") if k in jobs]:
        jobs[f"{name} stream"] = (without_last_fold(jobs[name][0], name), f"{name}_stream",
                                  ("segmented_gather.cu",), ())
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:  # every nvcc at once
        built = {k: pool.submit(build_library, *job) for k, job in jobs.items()}
        built = {k: f.result() for k, f in built.items()}
    this = built["this"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "reduce_probe_ptxas.txt"), "w") as f:
        f.write(this.ptxas_log)
    for kernel, regs, spills in registers(this.ptxas_log):
        print(f"ptxas, this tree: {kernel}: at most {regs} registers, "
              f"{spills} instantiations with spill stores")
    libs = {k: built[k] for k in ("this", "earlier") if k in built}
    turns = ("earlier", "this", "this", "earlier") if args.parent else ("this",)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_seg, segs = 2**28, 2048
    offsets = tuple(int(o) for o in packed_offsets(n_seg, segs, 0))
    x = torch.randn((n_seg,), generator=gen, device="cuda") * 2 + 0.3
    xb = x.to(torch.bfloat16)
    lanes = default_num_lanes(x)
    bf = torch.bfloat16
    calls = {k: Calls(v, torch, offsets) for k, v in libs.items()}
    lengths = torch.from_numpy(np.diff(offsets)).to("cuda")
    token = torch.rand((4, 512), generator=gen, device="cuda") * 4 + 9
    big = (torch.randn((2**26,), generator=gen, device="cuda") * 2 + 0.3).to(bf)

    def us(fn, match):
        return f"{cs.device_ms(fn, match, iters=10) * 1e3:.2f}"

    cases = (
        ("K8 2^28 f32 in 2048 segments, bf16 compute", "::segments_kernel<",
         lambda c: c.segments(x, lanes, bf),
         lambda: torch.segment_reduce(x, "sum", lengths=lengths)),
        ("K8 2^28 bf16 in 2048 segments", "::segments_kernel<",
         lambda c: c.segments(xb, lanes, bf),
         lambda: torch.segment_reduce(xb, "sum", lengths=lengths)),
        ("K1 (4, 512) f32, bf16 compute (the token sum)", "fused_sum_kernel",
         lambda c: c.fused(token, default_num_lanes(token), bf),
         lambda: torch.sum(token, dtype=torch.float32)),
        ("K1 2^26 bf16", "fused_sum_kernel", lambda c: c.fused(big, lanes, bf),
         lambda: torch.sum(big, dtype=torch.float32)),
        ("K1 2^28 f32, bf16 compute", "fused_sum_kernel", lambda c: c.fused(x, lanes, bf),
         lambda: torch.sum(x, dtype=torch.float32)),
        ("K2 (control) 2^28 f32, bf16 compute", "fused_sum_kernel",
         lambda c: c.fused(x, lanes, bf, moments=True), None),
        ("K3 (control) 2^28 f32, bf16 compute", "fused_kahan_kernel",
         lambda c: c.kahan(x, lanes, bf), None),
        ("K10 (control) level 0 of 2^28 f32, bf16 compute", "tile_partials_kernel",
         lambda c: c.level(x, bf), None),
    )
    for what, match, make, library in cases:
        fns = {k: make(c) for k, c in calls.items()}
        outs = {k: fn().clone() for k, fn in fns.items()}
        torch.cuda.synchronize()
        same = ""
        if "earlier" in outs:
            eq = torch.equal(outs["this"].nan_to_num(), outs["earlier"].nan_to_num())
            same = f"; bitwise the earlier kernel: {eq}"
            if what.startswith(("K8", "K1")):
                cs.check(eq, f"{what}: this tree's kernel differs from the earlier one")
        t = {}
        for turn in turns:
            t.setdefault(turn, []).append(us(fns[turn], match))
        lib = f"; library {us(library, None)}" if library is not None else ""
        print(f"{what}, device us: " + "; ".join(f"{k} {' / '.join(v)}" for k, v in t.items())
              + lib + same)

    for c in (132, 264, 528, 1056, 2112):
        t = us(calls["this"].segments(xb, c, bf), "::segments_kernel<")
        print(f"K8 2^28 bf16 over {c} lanes: {t} us")

    for name in libs:  # K8 less its last CTA's fold: the stream alone
        c = Calls(built[f"{name} stream"], torch, offsets)
        print(f"K8 without the last CTA's fold ({name}), 2^28 f32 / bf16: "
              f"{us(c.segments(x, lanes, bf), '::segments_kernel<')} / "
              f"{us(c.segments(xb, lanes, bf), '::segments_kernel<')} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
