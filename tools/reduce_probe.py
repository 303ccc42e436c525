#!/usr/bin/env python3
"""Probe of the striped and tiled sum kernels and the cross-entropy on one
GPU: the cross-entropy (K7) and the moments pair (K2), with the Kahan sum
(K3), the paper's level (K10), the segmented gather (K8) and the fused sum
(K1) as controls.

    python3 tools/reduce_probe.py [--parent DIR] [--variants]

Device time per call by the profiler (``chip_smoke.device_ms``), every
kernel called through its C entry point with the same arguments and
buffers, beside the PyTorch call that computes the same function:

  before/after  with ``--parent DIR`` (a checkout of an earlier commit, e.g.
                ``git archive <commit> | tar -x -C DIR``): the earlier
                commit's ``segmented_gather.cu``, ``fused_reduce.cu``,
                ``fused_kahan.cu``, ``tile_partials.cu`` and
                ``cross_entropy.cu``, built from DIR into one library (bound
                with DIR's own C signatures), and this tree's, in turns
                (earlier, this, this, earlier): K7 at the training shape
                (2048 x 50432 f32, pad logits past 50304, and the same in
                bf16) and at 256 x 50304 bf16 (``F.cross_entropy``
                beside it), held to this tree's plain version (1e-3) and
                bitwise on repeat; K2 (moments) at 2^28 f32 (bf16
                compute) and 2^28 bf16 (``torch.var_mean`` beside it: the
                two moments in one read), bitwise the earlier kernel, and
                bitwise at every input x compute dtype at 1, 3 and the
                default lanes over 2^24 values and on small sums (64
                sums of 8 values at one lane, where one element's rounding
                reaches the total; 65539 values at one lane, 3 x 2^17 + 5
                at three); the controls K3 at the
                default lanes and at one lane, K10 level 0 and the whole
                hierarchy (two launches), each at 2^28 f32 (bf16 compute)
                and 2^28 bf16 (``torch.sum`` beside them); K8 over 2^28
                values in 2048 packed segments (``torch.segment_reduce``),
                K1 at the token sum (4 x 512 f32), 2^26 bf16 and 2^28 f32.
                K10, K8, K3 and K1 must be bitwise the earlier kernels;
                K10 is also held bitwise at f32 and f16 compute and under
                the square and moments prologues. K3 is also held to its
                plain version and the f64 sum, and bitwise on repeat.
  variants      with ``--variants``: copies of this tree's
                ``cross_entropy.cu`` with one design choice changed (three
                steps a warp held at three CTAs a SM, ``expf`` for p in
                place of ``ex2.approx``, cached loads in place of
                streaming ones), timed beside this tree's K7 at the three
                shapes (the max |d| to this tree's kernel is printed, not
                checked); and ``fused_reduce.cu`` with the moments' f32
                square rounded before its add (``__fmul_rn``, in place of
                the one ``fmaf`` that the earlier element route compiled
                to), compared bitwise with the earlier K2 at f32 compute
                beside this tree's on the small sums, where one rounding
                shows.
  lanes         K8 at 2^28 bf16 over 132 to 2112 lanes.
  stream        K8 without its last CTA's fold over the lanes, and K3
                without its folds (each tree's): the stream alone, at 2^28
                f32 and bf16.
  registers     ``ptxas -v`` of each tree's sources (and of each variant):
                the most registers, any spill and any C75xx note of each
                kernel (this tree's whole listing is written to
                ``reduce_probe_ptxas.txt`` in the output directory).

Prints the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PROBE_SOURCES = ("segmented_gather.cu", "fused_reduce.cu", "fused_kahan.cu", "tile_partials.cu",
                 "cross_entropy.cu")
OUT_DIR = os.path.join(ROOT, "build", "reduce_probe")


def signatures_of(csrc: str) -> dict:
    """The C signatures (``build._SIGNATURES``) of the tree whose kernel
    sources are ``csrc``: its own ``build.py``, beside ``csrc``."""
    path = os.path.join(os.path.dirname(csrc), "build.py")
    spec = importlib.util.spec_from_file_location(f"probe_build_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def build_library(csrc: str, name: str, sources=PROBE_SOURCES, flags=(),
                  signatures=None) -> ctypes.CDLL:
    """``sources`` of ``csrc`` into one shared library (one nvcc each, in
    parallel), bound with ``signatures`` (by default those of the tree
    beside ``csrc``)."""
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
    lib.signatures = signatures if signatures is not None else signatures_of(csrc)
    for fn, argtypes in lib.signatures.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.ptxas_log = "\n".join(logs)
    return lib


# each tree's K3 right after its stream (this tree's, then the earlier one's)
_KAHAN_FOLD_MARKS = ("  // 1. the lane's own pass: acc rows 0..127, then -comp rows 0..127\n",
                     "  // lane partial: [acc rows 0..127][comp rows 0..127]\n")


def without_folds(csrc: str, name: str) -> str:
    """A copy of ``csrc`` whose K8 returns after the ticket (every CTA
    streams its lane and flushes, no CTA folds the lanes) and whose K3
    returns after its stream, writing one value of its carries (no lane
    pass, no ticket, no last CTA). The outputs are not the sums; only their
    times are read."""
    out = os.path.join(OUT_DIR, f"{name}_stream_csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "segmented_gather.cu")
    text = open(path).read()
    if "  if (!am_last) return;" not in text:
        raise RuntimeError("the gather's last-CTA test moved: update without_folds")
    with open(path, "w") as f:
        f.write(text.replace("  if (!am_last) return;", "  return;"))
    path = os.path.join(out, "fused_kahan.cu")
    text = open(path).read()
    mark = next((m for m in _KAHAN_FOLD_MARKS if m in text), None)
    if mark is None:
        raise RuntimeError("the Kahan kernel's fold moved: update without_folds")
    with open(path, "w") as f:
        f.write(text.replace(mark, "  if (t == 0) lane_part[2 * lane_id] = acc0 + comp0 + acc1 + "
                                   "comp1;  // the stream alone\n  return;\n" + mark))
    return out


# (name, source, [(text, replacement), ...]): one design choice of this
# tree's kernel changed
VARIANTS = (
    ("K7 three steps a warp, three CTAs a SM", "cross_entropy.cu",
     [("constexpr int CE_DEPTH = 2;", "constexpr int CE_DEPTH = 3;"),
      ("constexpr int CE_MIN_CTAS = 4;", "constexpr int CE_MIN_CTAS = 3;")]),
    ("K7 expf for p", "cross_entropy.cu",
     [("return ex2_approx((s - m) * 1.4426950408889634f);", "return expf(s - m);")]),
    ("K7 cached loads (__ldg)", "cross_entropy.cu",
     [("st.a[q] = __ldcs(", "st.a[q] = __ldg("), ("st.b[q] = __ldcs(", "st.b[q] = __ldg(")]),
    ("K2 f32 square rounded before its add", "fused_reduce.cu",
     [("fsum2 = fmaf(v, v, fsum2);", "fsum2 += __fmul_rn(v, v);")]),
)


def variant_csrc(csrc: str, index: int) -> str:
    """A copy of ``csrc`` with variant ``index``'s replacements made."""
    _, source, edits = VARIANTS[index]
    out = os.path.join(OUT_DIR, f"variant{index}_csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, source)
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {VARIANTS[index][0]}: {old!r} moved; update VARIANTS")
        text = text.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(text)
    return out


def registers(log: str) -> list:
    """(kernel, most registers, instantiations with spill stores, C75xx
    notes) per kernel name in a ptxas -v listing."""
    worst: dict = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or re.search(
            r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            continue
        kernel = next((k for k in ("segments_kernel", "fused_sum_kernel", "fused_kahan_kernel",
                                   "tile_partials_kernel", "ce_kernel")
                       if current and k in current), None)
        if kernel is None:
            continue
        if kernel == "fused_sum_kernel":  # <T, CD, PRO, CENSUS>: PRO 3 is K2, the rest K1
            k2 = re.search(r"fused_sum_kernelI\w+?Li\d+ELi3E", current)
            kernel += " (K2)" if k2 else " (K1)"
        regs, spills, notes = worst.get(kernel, (0, 0, 0))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            spills += 1
        notes += "C75" in line
        worst[kernel] = (regs, spills, notes)
    return [(k, *v) for k, v in sorted(worst.items())]


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

    def ce(self, logits, labels):
        """K7 through the library's own signature: the redesign's (scratch
        and ticket) or the earlier one (paired loads, no scratch)."""
        from repro_torch.kernels import build
        from repro_torch.kernels.cross_entropy import ops

        rows, width = logits.shape
        out = self.torch.empty((rows,), dtype=self.torch.float32, device="cuda")
        stream = build.stream_ptr(out)
        dt, size = build.dtype_code(logits), logits.element_size()
        lab = labels.to(self.torch.int32)
        if len(self.lib.signatures["ce_forward"]) == 9:
            even = int(width % 2 == 0 and logits.data_ptr() % (2 * size) == 0)

            def call():
                self._check(self.lib.ce_forward(logits.data_ptr(), lab.data_ptr(),
                                                out.data_ptr(), rows, width, width, even, dt,
                                                stream), "ce_forward")
                return out

            return call
        blocks = -(-rows // ops.BLOCK_ROWS)
        part = self.torch.empty((blocks * -(-width // 1024) * ops.BLOCK_ROWS * 2,),
                                dtype=self.torch.float32, device="cuda")
        ticket = self.torch.zeros((blocks,), dtype=self.torch.int32, device="cuda")
        vec = int(logits.data_ptr() % 16 == 0 and width * size % 16 == 0)

        def call():
            self._check(self.lib.ce_forward(logits.data_ptr(), lab.data_ptr(), out.data_ptr(),
                                            rows, width, width, vec, dt, part.data_ptr(),
                                            ticket.data_ptr(), stream), "ce_forward")
            return out

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

    def level(self, x, compute, prologue=0):
        """Level 0 of the hierarchy (prologue 3: the moments pair)."""
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        n = x.numel()
        t, r, blocks, tpad = ops.tile_geometry(n)
        shape = (tpad, 2) if prologue == 3 else (tpad,)
        out = self.torch.empty(shape, dtype=self.torch.float32, device="cuda")
        stream = build.stream_ptr(out)

        def call():
            self._check(self.lib.tp_level(
                x.data_ptr(), n, 1, build.dtype_code(x), build.DTYPE_CODES[compute], prologue,
                r, blocks, int(x.data_ptr() % 16 == 0), *self.chain, out.data_ptr(), stream),
                "tp_level")
            return out[:t]

        return call

    def hierarchy(self, x, compute):
        """Every level, as ``ops.mma_sum_hier`` launches them (two at
        2^28): level 0 on x, each level above on the f32 partials below."""
        from repro_torch.kernels import build
        from repro_torch.kernels.mma_reduce import ops

        first = self.level(x, compute)
        above, n = [], -(-x.numel() // ops.TILE)
        while n > 1:
            t, r, blocks, tpad = ops.tile_geometry(n)
            above.append((n, r, blocks, self.torch.empty((tpad,), dtype=self.torch.float32,
                                                         device="cuda")))
            n = t

        def call():
            v = first()
            for n, r, blocks, out in above:
                self._check(self.lib.tp_level(
                    v.data_ptr(), n, 1, 0, build.DTYPE_CODES[compute], 0, r, blocks,
                    int(v.data_ptr() % 16 == 0), *self.chain, out.data_ptr(),
                    build.stream_ptr(out)), "tp_level")
                v = out
            return v[:1]

        return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time against")
    ap.add_argument("--variants", action="store_true",
                    help="also time copies of this tree's K7 with one design constant changed")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.cross_entropy import cross_entropy_plain
    from repro_torch.kernels.mma_reduce import default_num_lanes, mma_sum_kahan_plain
    from repro_torch.launch.reduce_demo import packed_offsets

    if not torch.cuda.is_available():
        print("reduce_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    this_sig = signatures_of(str(build.CSRC))
    jobs = {"this": (str(build.CSRC), "this", PROBE_SOURCES, ("-Xptxas", "-v"), this_sig)}
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent), "src/repro_torch/kernels/csrc")
        jobs["earlier"] = (csrc, "earlier", PROBE_SOURCES, ("-Xptxas", "-v"), signatures_of(csrc))
    for name in [k for k in ("this", "earlier") if k in jobs]:
        jobs[f"{name} stream"] = (without_folds(jobs[name][0], name), f"{name}_stream",
                                  ("segmented_gather.cu", "fused_kahan.cu"), (), jobs[name][4])
    if args.variants:
        for i, (what, source, _) in enumerate(VARIANTS):
            jobs[what] = (variant_csrc(str(build.CSRC), i), f"variant{i}", (source,),
                          ("-Xptxas", "-v"), this_sig)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:  # every nvcc at once
        built = {k: pool.submit(build_library, *job) for k, job in jobs.items()}
        built = {k: f.result() for k, f in built.items()}
    this = built["this"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "reduce_probe_ptxas.txt"), "w") as f:
        f.write(this.ptxas_log)
    for tree in [k for k in ("this", "earlier") if k in built]:
        for kernel, regs, spills, notes in registers(built[tree].ptxas_log):
            print(f"ptxas, {tree} tree: {kernel}: at most {regs} registers, "
                  f"{spills} instantiations with spill stores, {notes} C75xx notes")
    libs = {k: built[k] for k in ("this", "earlier") if k in built}
    turns = ("earlier", "this", "this", "earlier") if args.parent else ("this",)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_seg, segs = 2**28, 2048
    offsets = tuple(int(o) for o in packed_offsets(n_seg, segs, 0))
    x = torch.randn((n_seg,), generator=gen, device="cuda") * 2 + 0.3
    xb = x.to(torch.bfloat16)
    lanes = default_num_lanes(x)
    bf, f32 = torch.bfloat16, torch.float32
    calls = {k: Calls(v, torch, offsets) for k, v in libs.items()}
    lengths = torch.from_numpy(np.diff(offsets)).to("cuda")
    token = torch.rand((4, 512), generator=gen, device="cuda") * 4 + 9
    big = (torch.randn((2**26,), generator=gen, device="cuda") * 2 + 0.3).to(bf)

    def us(fn, match):
        return f"{cs.device_ms(fn, match, iters=10) * 1e3:.2f}"

    def tsum(v):
        return lambda: torch.sum(v, dtype=f32)

    def tvar(v):
        return lambda: torch.var_mean(v, correction=0)

    # K7: the training shape's padded logits (f32, and the same in bf16), the
    # card tests' 256 x 50304 bf16
    rows, width, vocab = 2048, 50432, 50304
    ce_in = {}
    for what, r, w, dt in (("2048 x 50432 f32", rows, width, f32),
                           ("2048 x 50432 bf16", rows, width, bf),
                           ("256 x 50304 bf16", 256, vocab, bf)):
        lg = torch.randn((r, w), generator=gen, device="cuda") * 3
        lg[:, vocab:] = -1e30
        ce_in[what] = (lg.to(dt), torch.randint(0, vocab, (r,), generator=gen, device="cuda"))

    def ce_library(what):
        lg, lab = ce_in[what]
        return lambda: F.cross_entropy(lg, lab, reduction="none")

    kahan, level, ce = "::fused_kahan_kernel<", "::tile_partials_kernel<", "::ce_kernel<"
    cases = tuple(
        (f"K7 {what}", ce, lambda c, what=what: c.ce(*ce_in[what]), ce_library(what))
        for what in ce_in) + (
        ("K2 2^28 f32, bf16 compute", "fused_sum_kernel",
         lambda c: c.fused(x, lanes, bf, moments=True), tvar(x)),
        ("K2 2^28 bf16", "fused_sum_kernel", lambda c: c.fused(xb, lanes, bf, moments=True),
         tvar(xb)),
        (f"K3 2^28 f32, bf16 compute, {lanes} lanes", kahan, lambda c: c.kahan(x, lanes, bf),
         tsum(x)),
        (f"K3 2^28 bf16, {lanes} lanes", kahan, lambda c: c.kahan(xb, lanes, bf), tsum(xb)),
        ("K3 2^28 f32, bf16 compute, one lane", kahan, lambda c: c.kahan(x, 1, bf), None),
        ("K3 2^28 bf16, one lane", kahan, lambda c: c.kahan(xb, 1, bf), None),
        ("K10 level 0 of 2^28 f32, bf16 compute", level, lambda c: c.level(x, bf), tsum(x)),
        ("K10 level 0 of 2^28 bf16", level, lambda c: c.level(xb, bf), tsum(xb)),
        ("K10 hierarchy (2 launches) 2^28 f32, bf16 compute", level,
         lambda c: c.hierarchy(x, bf), None),
        ("K10 hierarchy (2 launches) 2^28 bf16", level, lambda c: c.hierarchy(xb, bf), None),
        ("K8 2^28 f32 in 2048 segments, bf16 compute", "::segments_kernel<",
         lambda c: c.segments(x, lanes, bf),
         lambda: torch.segment_reduce(x, "sum", lengths=lengths)),
        ("K8 2^28 bf16 in 2048 segments", "::segments_kernel<",
         lambda c: c.segments(xb, lanes, bf),
         lambda: torch.segment_reduce(xb, "sum", lengths=lengths)),
        ("K1 (4, 512) f32, bf16 compute (the token sum)", "fused_sum_kernel",
         lambda c: c.fused(token, default_num_lanes(token), bf),
         lambda: torch.sum(token, dtype=f32)),
        ("K1 2^26 bf16", "fused_sum_kernel", lambda c: c.fused(big, lanes, bf), tsum(big)),
        ("K1 2^28 f32, bf16 compute", "fused_sum_kernel", lambda c: c.fused(x, lanes, bf),
         tsum(x)),
    )
    for what, match, make, library in cases:
        fns = {k: make(c) for k, c in calls.items()}
        outs = {k: fn().clone() for k, fn in fns.items()}
        torch.cuda.synchronize()
        same = ""
        if "earlier" in outs:
            eq = torch.equal(outs["this"].nan_to_num(), outs["earlier"].nan_to_num())
            same = f"; bitwise the earlier kernel: {eq}"
            if what.startswith(("K10", "K8", "K1 ", "K2", "K3")):
                cs.check(eq, f"{what}: this tree's kernel differs from the earlier one")
        if what.startswith("K7"):
            lg, lab = ce_in[what[3:]]
            got, again = outs["this"], fns["this"]().clone()
            d_plain = float((got - cross_entropy_plain(lg, lab)).abs().max())
            same += (f"; vs its plain version max |d| {d_plain:.3g} (tol 1e-3); repeat bitwise "
                     f"{torch.equal(got, again)}")
            if "earlier" in outs:
                d_earlier = float((got - outs["earlier"]).abs().max())
                same += f"; vs the earlier kernel max |d| {d_earlier:.3g}"
            finite = bool(torch.isfinite(got).all())
            cs.check(d_plain <= 1e-3 and torch.equal(got, again) and finite,
                     f"{what}: off its plain version, not finite, or a repeat differs")
        if what.startswith("K3"):
            n_lanes = lanes if "one lane" not in what else 1
            xin = xb if "bf16," in what else x
            got, again = outs["this"], fns["this"]().clone()
            plain = float(mma_sum_kahan_plain(xin, bf, "identity", (), n_lanes))
            exact = float(xin.to(bf).double().sum())
            mass = float(xin.to(bf).double().abs().sum())
            tol = 2.0**-20 * mass
            d_plain, d_exact = abs(float(got) - plain), abs(float(got) - exact)
            same += (f"; vs its plain version |d| {d_plain:.4g}, vs f64 |d| {d_exact:.4g} "
                     f"(tol {tol:.4g}); repeat bitwise {torch.equal(got, again)}")
            cs.check(d_plain <= tol and d_exact <= tol + 1e-3 and torch.equal(got, again),
                     f"{what}: off its plain version or the f64 sum, or a repeat differs")
            if "earlier" in outs:
                same += f"; earlier kernel {float(outs['earlier']):.9g}, this {float(got):.9g}"
        t = {}
        for turn in turns:
            t.setdefault(turn, []).append(us(fns[turn], match))
        lib = f"; library {us(library, None)}" if library is not None else ""
        print(f"{what}, device us: " + "; ".join(f"{k} {' / '.join(v)}" for k, v in t.items())
              + lib + same)

    if "earlier" in calls:  # K10 bitwise at every compute dtype and under its prologues
        xh = (x - 0.3).to(torch.float16)  # mean 0: f16 partials of a 0.3 mean overflow
        for what, v, cd, pro in (("f32 at f32 compute", x, f32, 0), ("bf16, square", xb, bf, 1),
                                 ("bf16, abs", xb, bf, 2), ("bf16, moments", xb, bf, 3),
                                 ("f32 at bf16 compute, moments", x, bf, 3),
                                 ("f16", xh, torch.float16, 0), ("f16, moments", xh,
                                                                torch.float16, 3),
                                 ("f32 at f16 compute", x - 0.3, torch.float16, 0)):
            a, b = (calls[k].level(v, cd, pro)().clone() for k in ("earlier", "this"))
            eq = torch.equal(a.nan_to_num(), b.nan_to_num())
            print(f"K10 level 0 of 2^28 {what}: bitwise the earlier kernel: {eq}")
            cs.check(eq, f"K10 level 0 of 2^28 {what}: this tree's kernel differs")
        a, b = (calls[k].hierarchy(x, f32)() for k in ("earlier", "this"))
        cs.check(torch.equal(a, b), "K10 hierarchy at f32 compute differs from the earlier one")

    # K2 on 64 sums of 8 values at one lane: one thread's sum is the total,
    # so one element's rounding reaches it; then 65539 values at one lane,
    # 3 x 2^17 + 5 at three, 2^24 at 1, 3 and the default lanes
    small = x[:2**24] - 0.3
    k2_cells = ([(small[8 * i:8 * i + 8], 1) for i in range(64)]
                + [(small[:65539], 1), (small[:3 * 131072 + 5], 3)]
                + [(small, n_lanes) for n_lanes in (1, 3, lanes)])

    def k2_same(a_calls, b_calls, dt, cd):
        return [torch.equal(a_calls.fused(v.to(dt), n, cd, moments=True)().clone(),
                            b_calls.fused(v.to(dt), n, cd, moments=True)().clone())
                for v, n in k2_cells]

    def k2_report(same):
        return (f"{sum(same[:64])} of 64 sums of 8 values, n = 65539 / 393221: "
                f"{same[64:66]}, 2^24 over 1 / 3 / {lanes} lanes: {same[66:]}")

    if "earlier" in calls:  # K2 bitwise at every input x compute dtype and lane count
        for dt in (f32, bf, torch.float16):
            for cd in (f32, bf, torch.float16):
                same = k2_same(calls["earlier"], calls["this"], dt, cd)
                print(f"K2 {str(dt)[6:]} at {str(cd)[6:]} compute, bitwise the earlier kernel: "
                      + k2_report(same))
                cs.check(all(same), f"K2 {dt} at {cd} compute differs from the earlier kernel")

    if args.variants:
        for what, source, _ in VARIANTS:
            var = built[what]
            for kernel, regs, spills, notes in registers(var.ptxas_log):
                print(f"ptxas, {what}: {kernel}: at most {regs} registers, {spills} "
                      f"instantiations with spill stores, {notes} C75xx notes")
            vc = Calls(var, torch, offsets)
            if source == "fused_reduce.cu":
                for dt in (f32, bf):
                    for k, c in calls.items():
                        print(f"{what}, {str(dt)[6:]} at f32 compute, bitwise the {k} kernel: "
                              + k2_report(k2_same(vc, c, dt, f32)))
                continue
            for case in ce_in:
                fv, ft = vc.ce(*ce_in[case]), calls["this"].ce(*ce_in[case])
                d = float((fv().clone() - ft().clone()).abs().max())
                print(f"{what}, K7 {case}, device us: this {us(ft, ce)}, variant {us(fv, ce)} / "
                      f"{us(fv, ce)}, this {us(ft, ce)}; max |d| to this {d:.3g}")

    for c in (132, 264, 528, 1056, 2112):
        t = us(calls["this"].segments(xb, c, bf), "::segments_kernel<")
        print(f"K8 2^28 bf16 over {c} lanes: {t} us")

    for name in libs:  # K8 less its last CTA's fold, K3 less its folds: the streams alone
        c = Calls(built[f"{name} stream"], torch, offsets)
        print(f"K8 without the last CTA's fold ({name}), 2^28 f32 / bf16: "
              f"{us(c.segments(x, lanes, bf), '::segments_kernel<')} / "
              f"{us(c.segments(xb, lanes, bf), '::segments_kernel<')} us")
        print(f"K3 without its folds ({name}), 2^28 f32 / bf16, {lanes} lanes: "
              f"{us(c.kahan(x, lanes, bf), kahan)} / {us(c.kahan(xb, lanes, bf), kahan)} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
