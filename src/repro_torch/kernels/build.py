"""Build and load the CUDA kernels: nvcc -> one shared library -> ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so each compiles in seconds. ``library()`` builds them at first use into
``build/repro_torch/<hash>/libkernels.so`` at the repository root (one
``nvcc -c`` per source, all started together, then one link) and loads the
result with ctypes. The hash covers the sources and the flags, so an edited
source is rebuilt and a finished build is reused.

Nothing here runs at import: the CPU test suite imports every module
without ``nvcc`` or a card, and only the CUDA path of a kernel wrapper
calls ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "row_moments.cu", "flash_attention.cu", "flash_attention_wide.cu", "parts_reduce.cu",
    "cross_entropy.cu", "fused_reduce.cu", "fused_kahan.cu", "tile_partials.cu",
    "segmented_gather.cu", "scan.cu", "matmul_stats.cu",
)
HEADERS = ("common.cuh", "reduce_common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "rm_layernorm_np": (_P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P),
    "rm_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P),
    "fa_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "pr_parts": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                 _P, _P, _P, _P),
    "ce_forward": (_P, _P, _P, _I, _LL, _I, _I, _I, _P, _P, _P),
    "ce_partial": (_P, _P, _P, _I, _LL, _I, _I, _I, _I, _P, _P, _P),
    "fr_sum": (_P, _LL, _I, _I, _I, _I, _LL, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "fr_moments": (_P, _LL, _I, _I, _LL, _LL, _I, _I, _P, _P, _P, _P),
    "fk_sum": (_P, _LL, _I, _I, _I, _I, _LL, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "tp_level": (_P, _LL, _LL, _I, _I, _I, _I, _LL, _I, _I, _P, _P, _P, _P, _P),
    "sg_segments": (_P, _LL, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                    _P),
    "sc_scan": (_P, _LL, _I, _I, _I, _I, _P, _P, _I, _P),
    "ms_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link ``libkernels.so``; reuse a
    finished build of the same sources and flags. Returns its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [compiler, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent builder sees all or none
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned an error (its cudaGetLastError)."""
    if err:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32, bfloat16 or float16; got {t.dtype}"
        ) from None
