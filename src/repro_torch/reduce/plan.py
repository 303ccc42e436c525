"""Reduction planning: backend and dtypes for one reduction or scan.

Port of ``repro/reduce/plan.py``: the frozen ``ReducePlan``, ``plan_for`` with the reference's
defaults (f32 accumulation; the exactness-sensitive kinds sumsq/norm2
multiply at f32, other float reductions -- sum, mean, moments -- at bf16,
the tensor-core mode the paper analyzes), the process default backend,
``backend_for_flags`` and the circuit breaker's quarantine, with the
reference's precision policy (``precision``, ``kahan_block``) and block
depth (``tiles_per_block``).

Backend resolution: an explicit ``backend=`` wins; else the process
default (``set_default_backend``); else "auto", which picks the MMA
algorithm ``mma_torch`` for reductions longer than one tile and plain
``torch`` below (the reference's off-TPU choice). The kernel backend
``cuda_fused`` is reached by name (the launchers' ``--reduce-backend``,
the guard's breaker chain) or by the config flags (``backend_for_flags``);
``cuda_hier`` (the paper's multi-launch hierarchy) by name. Quarantined
backends leave AUTO rotation along cuda_fused -> mma_torch, cuda_hier ->
mma_torch, mma_torch -> torch; explicit pins still reach them (the
breaker's half-open probes).

Segmented multi-reduce problems (``plan_for(..., segments=N)``, the route of
``reduce_many``) go to the registered "segmented" backend on auto, which
picks its executor per call (``segmented_backend_for``). Scans have their
own plan (``ScanPlan`` / ``scan_plan_for``): compute at the operand's own
dtype, and on auto the scan kernel for a long 1-D float stream on a CUDA
device. Plans are not memoized here (they are small frozen dataclasses).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import MXU, native_ingest_dtype

_default_backend: Optional[str] = None
_QUARANTINED: set = set()
_QUARANTINE_FALLBACK = {"cuda_fused": "mma_torch", "cuda_hier": "mma_torch",
                        "mma_torch": "torch"}
# The kernel routes take a problem only when it spans at least this many
# full tiles (the reference's _MIN_PALLAS_TILES).
_MIN_KERNEL_TILES = 2
PRECISIONS = ("native", "kahan")

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        return dtype
    return str(dtype).replace("torch.", "")


def _is_float(dtype) -> bool:
    """True for floating dtypes (a torch dtype or one of the dtype names)."""
    if isinstance(dtype, str):
        return dtype in _DTYPES
    return dtype.is_floating_point


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """backend: registry name ("torch" | "mma_torch" | "cuda_hier" |
    "cuda_fused"); m: the MMA tile size; tiles_per_block: m^2 tiles per
    block of the kernels' grids; compute_dtype: dtype of the MMA
    multipliers; accum_dtype: accumulator / result dtype (dtype names, so
    plans hash); num_lanes: the fused kernels' lane (CTA) count -- None
    leaves it to the device (``kernels.mma_reduce.default_num_lanes``: 1 on
    the CPU); precision: "native" or "kahan" (the compensated sum: in the
    fused kernel's carry on cuda_fused, the blocked combine elsewhere);
    kahan_block: the blocked combine's block length."""

    backend: str = "mma_torch"
    m: int = MXU
    tiles_per_block: int = 8
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    num_lanes: Optional[int] = None
    precision: str = "native"
    kahan_block: int = 4096

    def __post_init__(self):
        if self.m < 2:
            raise ValueError(f"m must be >= 2; got {self.m}")
        if self.tiles_per_block < 1:
            raise ValueError(f"tiles_per_block must be >= 1; got {self.tiles_per_block}")
        if self.num_lanes is not None and self.num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1 or None; got {self.num_lanes}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision policy {self.precision!r}; expected {PRECISIONS}")
        if self.kahan_block < 1:
            raise ValueError(f"kahan_block must be >= 1; got {self.kahan_block}")

    @property
    def compute_torch(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def accum_torch(self) -> torch.dtype:
        return _DTYPES[self.accum_dtype]

    def replace(self, **kw) -> "ReducePlan":
        return dataclasses.replace(self, **kw)


def set_default_backend(name: Optional[str]) -> None:
    """Set the process-wide default backend (None restores auto)."""
    global _default_backend
    _default_backend = name


def default_backend() -> str:
    return _default_backend if _default_backend is not None else "auto"


def quarantine_backend(name: str) -> None:
    """Take ``name`` out of AUTO rotation (circuit-breaker trip)."""
    _QUARANTINED.add(str(name))


def reinstate_backend(name: str) -> None:
    """Undo ``quarantine_backend`` (breaker close)."""
    _QUARANTINED.discard(str(name))


def quarantined_backends() -> Tuple[str, ...]:
    return tuple(sorted(_QUARANTINED))


def _dequarantine(name: str) -> str:
    while name in _QUARANTINED:
        nxt = _QUARANTINE_FALLBACK.get(name)
        if nxt is None:
            return name  # terminal: serve it even quarantined
        name = nxt
    return name


def backend_for_flags(mma: bool, use_kernels: bool = False) -> str:
    """Map the config pair (cfg.mma_reductions, cfg.use_kernels) onto a
    registry name, as the reference maps (mma_reductions, use_pallas):
    ``torch`` without the paper's technique, ``cuda_fused`` with it on the
    kernels, else ``mma_torch``. An explicit process default (the
    launchers' ``--reduce-backend``) overrides the flags."""
    if _default_backend:
        return _default_backend
    if not mma:
        return "torch"
    return "cuda_fused" if use_kernels else "mma_torch"


def plan_for(
    shape: Sequence[int],
    dtype,
    *,
    kind: str = "sum",
    axis=None,
    backend: Optional[str] = None,
    compute_dtype=None,
    accum_dtype=None,
    num_lanes: Optional[int] = None,
    tiles_per_block: Optional[int] = None,
    precision: Optional[str] = None,
    kahan_block: Optional[int] = None,
    segments: Optional[int] = None,
) -> ReducePlan:
    """The plan for reducing ``shape``/``dtype`` over ``axis`` (the reduced
    extent picks the auto backend; unset fields follow the reference:
    8 tiles per block, native precision, Kahan blocks of 4096).
    ``segments=N`` marks a multi-reduce of N pieces (``shape`` is then the
    packed stream): on auto it routes to the "segmented" backend."""
    name = backend if backend is not None else default_backend()
    if name == "auto" and segments is not None:
        name = "segmented"
    if name == "auto":
        axes = range(len(shape)) if axis is None else (
            (axis,) if isinstance(axis, int) else tuple(axis))
        n = math.prod(int(shape[a]) for a in axes)
        name = _dequarantine("mma_torch" if n > MXU else "torch")
    dt = dtype_name(dtype)
    if accum_dtype is None:
        accum_dtype = "float64" if dt == "float64" else "float32"
    if compute_dtype is None:
        if dt == "float64":
            compute_dtype = "float64"
        elif dt not in _DTYPES:
            compute_dtype = "float32"  # integer/bool data: exact f32 MMA
        elif kind in ("sumsq", "norm2"):
            compute_dtype = "float32"  # exactness matters for clipping
        else:
            compute_dtype = "bfloat16"
    return ReducePlan(
        backend=name,
        compute_dtype=dtype_name(compute_dtype),
        accum_dtype=dtype_name(accum_dtype),
        num_lanes=num_lanes,
        tiles_per_block=8 if tiles_per_block is None else int(tiles_per_block),
        precision="native" if precision is None else precision,
        kahan_block=4096 if kahan_block is None else int(kahan_block),
    )


def segmented_backend_for(n: int, dtype, m: int = MXU, device=None) -> str:
    """The executor of a segmented multi-reduce of ``n`` elements in all
    (the "segmented" backend's per-call choice, the reference's rules with
    "on a real TPU" read as "the operand lies on a CUDA device"): exact
    ``torch`` for non-float data and for n <= m; the kernels
    (``cuda_fused``) for streams of at least two m^2 tiles at m = 128 on a
    CUDA device; ``mma_torch`` otherwise. Quarantine applies."""
    if not _is_float(dtype) or n <= m:
        return "torch"
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and m == MXU and n >= _MIN_KERNEL_TILES * m * m:
        return _dequarantine("cuda_fused")
    return _dequarantine("mma_torch")


# ------------------------------- scan plans ----------------------------------


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one prefix sum runs (the reference's fields, ``num_lanes`` for
    ``num_cores``): backend ("torch": ``torch.cumsum`` at f32; "mma_torch":
    the batched triangular product; "cuda_fused" / "cuda_hier": the scan
    kernel for 1-D streams), the tile m, tiles per block, the kernel's lane
    count (contiguous block ranges; 1 by default on every device: more lanes
    only add carry-rebuild reads), and dtype names. The compute dtype
    defaults to the operand's own ingest dtype, not bf16: every partial of a
    scan is an output."""

    backend: str = "mma_torch"
    m: int = MXU
    tiles_per_block: int = 8
    num_lanes: int = 1
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"

    def __post_init__(self):
        if self.m < 2:
            raise ValueError(f"m must be >= 2; got {self.m}")
        if self.num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1; got {self.num_lanes}")
        if self.tiles_per_block < 1:
            raise ValueError(f"tiles_per_block must be >= 1; got {self.tiles_per_block}")

    @property
    def compute_torch(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def accum_torch(self) -> torch.dtype:
        return _DTYPES[self.accum_dtype]

    def replace(self, **kw) -> "ScanPlan":
        return dataclasses.replace(self, **kw)

    def hbm_bytes(self, n: int, dtype):
        """Modeled bytes of scanning n elements of ``dtype`` under this plan:
        ``cost_model.scan_hbm_bytes`` on the kernel backends (non-native
        input at the f32 width it is cast to), one read and one write of
        the operand elsewhere."""
        from repro_torch.core import cost_model

        itemsize = torch.empty((), dtype=dtype).element_size()
        if self.backend in ("cuda_fused", "cuda_hier"):
            return cost_model.scan_hbm_bytes(
                n, itemsize if native_ingest_dtype(dtype) else 4, m=self.m,
                num_cores=self.num_lanes, tiles_per_block=self.tiles_per_block)
        return cost_model.HbmTraffic(kernel_read=n * itemsize, kernel_write=n * itemsize)


def _auto_scan_backend(shape, dtype, m: int, device) -> str:
    """Non-float data: exact integer adds (``torch``). Batched and short
    streams: ``mma_torch`` (``torch`` up to one row of m). A long 1-D float
    stream: the scan kernel on a CUDA device, else ``mma_torch``."""
    n = int(shape[-1]) if shape else 1
    if not _is_float(dtype):
        return "torch"
    if len(shape) > 1 or n < _MIN_KERNEL_TILES * m * m:
        return "mma_torch" if n > m else "torch"
    if device is not None and torch.device(device).type == "cuda":
        return "cuda_fused"
    return "mma_torch"


def scan_plan_for(
    shape: Sequence[int],
    dtype,
    *,
    backend: Optional[str] = None,
    m: Optional[int] = None,
    tiles_per_block: Optional[int] = None,
    num_lanes: Optional[int] = None,
    compute_dtype=None,
    device=None,
) -> ScanPlan:
    """The plan for scanning ``shape``/``dtype`` over its LAST axis.
    Unset fields follow ``ScanPlan``; the backend resolves as ``plan_for``
    does (explicit, process default, auto with quarantine), ``device`` the
    operand's (auto picks the kernel only on a CUDA device)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    m_ = MXU if m is None else int(m)
    name = backend if backend is not None else default_backend()
    if name == "auto":
        name = _dequarantine(_auto_scan_backend(tuple(shape), dtype, m_, device))
    if compute_dtype is None:
        compute_dtype = dtype if native_ingest_dtype(dtype) else "float32"
    return ScanPlan(
        backend=name,
        m=m_,
        tiles_per_block=8 if tiles_per_block is None else int(tiles_per_block),
        num_lanes=1 if num_lanes is None else int(num_lanes),
        compute_dtype=dtype_name(compute_dtype),
        accum_dtype="float32",
    )
