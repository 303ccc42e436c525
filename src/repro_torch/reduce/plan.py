"""Reduction planning: backend and dtypes for one reduction or scan.

Port of ``repro/reduce/plan.py``: the frozen ``ReducePlan``, ``plan_for`` with the reference's
defaults (f32 accumulation; the exactness-sensitive kinds sumsq/norm2
multiply at f32, other float reductions -- sum, mean, moments -- at bf16,
the tensor-core mode the paper analyzes), the process default backend,
``backend_for_flags`` and the circuit breaker's quarantine, with the
reference's precision policy (``precision``, ``kahan_block``) and block
depth (``tiles_per_block``).

Backend resolution: an explicit ``backend=`` wins; else the process
default (``set_default_backend``); else "auto", the reference's
``_auto_backend`` with its names mapped (xla -> torch, mma_jnp ->
mma_torch, "on a real TPU" -> "the operand lies on a CUDA device"):
non-float data -> ``torch`` (exact adds); reductions over axes ->
``mma_torch`` for an extent above m, else ``torch``; a full reduction of
at least ``_MIN_KERNEL_TILES`` m^2 tiles on a CUDA device -> the fused
kernel ``cuda_fused``, when the kernels read the plan's dtypes (compute
at f32, bf16 or f16; under Kahan the accumulator too, since the census
multiplies at its width) and else ``mma_torch``; anything else -> ``mma_torch`` above m, ``torch``
up to m. The kernel backends are also reached by name (the launchers'
``--reduce-backend``, the guard's breaker chain) or by the config flags
(``backend_for_flags``); ``cuda_hier`` (the paper's multi-launch
hierarchy) only by name. Quarantined backends leave AUTO rotation along
cuda_fused -> mma_torch, cuda_hier -> mma_torch, mma_torch -> torch;
explicit pins still reach them (the breaker's half-open probes).

Segmented multi-reduce problems (``plan_for(..., segments=N)``, the route of
``reduce_many``) go to the registered "segmented" backend on auto, which
picks its executor per call (``segmented_backend_for``). Scans have their
own plan (``ScanPlan`` / ``scan_plan_for``): compute at the operand's own
dtype, and on auto the scan kernel for a long 1-D float stream on a CUDA
device.

Resolution of the default: ``set_default_backend``, then
``$REPRO_TORCH_REDUCE_BACKEND`` (read at call time; its own name because
the port's backend names differ from the reference's
``$REPRO_REDUCE_BACKEND``), then "auto".

Plan cache: ``plan_for`` and ``scan_plan_for`` are memoized (an LRU of
``_PLAN_CACHE_SIZE`` entries each, the reference's) on the normalized
arguments AND the operand's device type: the port's auto route depends on
the device, so a plan made for a CPU operand is never served to a CUDA
one. The process default is resolved before the lookup, so changing it
never serves a stale plan. ``quarantine_backend``, ``reinstate_backend``,
``plan_cache_clear`` and ``autotune`` drop both memos.

Autotuning: ``autotune(shape, dtype, ...)`` times every candidate backend
(and, on the kernel backends, every ``tiles_per_block`` x ``num_lanes``)
on the live device and records the winner in a table keyed by the problem
and the device type; later ``plan_for`` calls that would auto-select take
it. Only candidates the planner or a wrapper refuses before launch (their
documented ``ValueError``, ``TypeError``, ``NotImplementedError``) are
skipped; anything else -- a CUDA error above all -- propagates.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import MXU, NATIVE_INGEST_DTYPES, native_ingest_dtype

# Environment override of the process default backend (read at call time).
BACKEND_ENV = "REPRO_TORCH_REDUCE_BACKEND"
# plan_for / scan_plan_for memo depth (the reference's).
_PLAN_CACHE_SIZE = 1024

_default_backend: Optional[str] = None
# autotune()'s winners by (shape, dtype, kind, axis, segments, device type)
_TUNED: Dict[Tuple, "ReducePlan"] = {}
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

    def hbm_bytes(self, n: int, dtype, *, segments: Optional[int] = None,
                  prologue: str = "identity", epilogue: int = 0, census: bool = False):
        """Modeled bytes of reducing ``n`` elements of ``dtype`` under this
        plan: the reference's ``ReducePlan.hbm_bytes`` with the names mapped
        (cuda_fused -> pallas_fused, cuda_hier -> pallas_hier, mma_torch ->
        mma_jnp, torch -> xla), byte for byte, over ``core.cost_model``. The
        kernel backends read f32, bf16 and f16 in place and pay an f32 staging
        copy for anything else; ``segments`` models the multi-reduce launch
        (the parts kernel on the kernel backends); square/abs prologues move
        no extra bytes, "moments" doubles the outputs; ``epilogue`` counts
        the extra output slots of a multi-reduce, or (truthy) marks a full
        reduction's single-lane in-launch finish; ``census`` adds S + 1
        output slots to a multi-reduce. The lane count is ``num_lanes``, 1
        when the plan leaves it to the device.

        On cuda_fused with more than one lane this is the reference's model,
        not the port's kernel: the model charges (C, m, m) f32 lane partials
        written and read back by a combine, while K1/K2/K3 fold their lanes
        inside the launch and write the finished scalar(s) plus one or two
        words a lane (``cost_model.fused_launch_bytes``). The read side, and
        every byte of the one-lane finish, the hierarchy and the parts
        kernel, agree with what the launches move."""
        from repro_torch.core import cost_model

        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        itemsize = torch.empty((), dtype=dt).element_size()
        native = native_ingest_dtype(dt)
        lanes = 1 if self.num_lanes is None else self.num_lanes
        dual = prologue == "moments"
        kernel = self.backend in ("cuda_fused", "cuda_hier", "segmented")
        census_slots = (int(segments) + 1) if census and segments else 0
        if segments is not None and kernel:
            return cost_model.hbm_bytes(
                "parts", n, itemsize if native else 4,
                segments=((2 * segments) if dual else segments) + int(epilogue),
                census=census_slots)
        if segments is not None:
            return cost_model.hbm_bytes(
                "segmented", n, itemsize, segments=(2 * segments) if dual else segments,
                num_cores=lanes, census=int(segments) if census else 0)
        if self.backend == "cuda_hier":
            path = ("hier_moments" if dual else "hier") if native else "fused_staged"
        elif kernel:
            path = "fused" if native else "fused_staged"
        else:
            return cost_model.HbmTraffic(kernel_read=n * itemsize, kernel_write=8 if dual else 4)
        return cost_model.hbm_bytes(
            path, n, itemsize, m=self.m, num_cores=lanes, tiles_per_block=self.tiles_per_block,
            kahan=self.precision == "kahan" and self.backend == "cuda_fused",
            dual=dual and path == "fused", epilogue=bool(epilogue) and path == "fused")


def set_default_backend(name: Optional[str]) -> None:
    """Set the process-wide default backend (None restores auto)."""
    global _default_backend
    _default_backend = name


def default_backend() -> str:
    """Resolution order: set_default_backend, then $REPRO_TORCH_REDUCE_BACKEND,
    then "auto"."""
    if _default_backend is not None:
        return _default_backend
    return os.environ.get(BACKEND_ENV) or "auto"


def quarantine_backend(name: str) -> None:
    """Take ``name`` out of AUTO rotation (circuit-breaker trip) and drop the
    memoized plans, so no cached auto plan goes on serving it."""
    _QUARANTINED.add(str(name))
    plan_cache_clear()


def reinstate_backend(name: str) -> None:
    """Undo ``quarantine_backend`` (breaker close); drops the memoized plans."""
    _QUARANTINED.discard(str(name))
    plan_cache_clear()


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
    launchers' ``--reduce-backend``, or $REPRO_TORCH_REDUCE_BACKEND)
    overrides the flags."""
    override = _default_backend or os.environ.get(BACKEND_ENV)
    if override:
        return override
    if not mma:
        return "torch"
    return "cuda_fused" if use_kernels else "mma_torch"


def kernels_take(compute_dtype, accum_dtype, precision: str) -> bool:
    """Whether the kernel backends run a plan with these fields: their
    multipliers are f32, bf16 or f16 (f64 stays on mma_torch), and under
    ``precision="kahan"`` the census multiplies at the accumulator's dtype."""
    dts = (compute_dtype, accum_dtype) if precision == "kahan" else (compute_dtype,)
    return all(_DTYPES.get(dtype_name(d)) in NATIVE_INGEST_DTYPES for d in dts)


def _auto_backend(shape, dtype, axis, device) -> str:
    """The reference's ``_auto_backend`` at m = 128, names mapped (see the
    module docstring); ``plan_for`` then keeps off the kernels what they
    cannot read (``kernels_take``)."""
    axes = range(len(shape)) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    n = math.prod(int(shape[a]) for a in axes)
    if not _is_float(dtype):
        return "torch"
    if axis is not None or n < _MIN_KERNEL_TILES * MXU * MXU:
        return "mma_torch" if n > MXU else "torch"
    if device is not None and torch.device(device).type == "cuda":
        return "cuda_fused"
    return "mma_torch"


def _device_type(device) -> Optional[str]:
    """The memo key of an operand's device: its type ("cpu", "cuda"), or
    None when no device is given."""
    return None if device is None else torch.device(device).type


def _norm_axis(axis, ndim: int):
    """Canonical key form of ``axis``: a sorted non-negative tuple, or None
    (the reference's ``_norm_axis_arg``)."""
    if axis is None or ndim == 0:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(sorted(int(a) % ndim for a in axes))


def _problem_key(shape, dtype_s, kind, axis, segments, device_type) -> Tuple:
    return (shape, dtype_s, kind, axis, segments, device_type)


@functools.lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _plan_for_cached(shape, dtype_s, kind, axis, name, compute_dtype, accum_dtype, num_lanes,
                     tiles_per_block, precision, kahan_block, segments,
                     device_type) -> ReducePlan:
    if name == "auto" and segments is not None:
        name = "segmented"
    if accum_dtype is None:
        accum_dtype = "float64" if dtype_s == "float64" else "float32"
    if compute_dtype is None:
        if dtype_s == "float64":
            compute_dtype = "float64"
        elif dtype_s not in _DTYPES:
            compute_dtype = "float32"  # integer/bool data: exact f32 MMA
        elif kind in ("sumsq", "norm2"):
            compute_dtype = "float32"  # exactness matters for clipping
        else:
            compute_dtype = "bfloat16"
    precision = "native" if precision is None else precision
    if name == "auto":
        tuned = _TUNED.get(_problem_key(shape, dtype_s, kind, axis, segments, device_type))
        if tuned is not None:
            name = tuned.backend
            tiles_per_block = tuned.tiles_per_block if tiles_per_block is None else tiles_per_block
            num_lanes = tuned.num_lanes if num_lanes is None else num_lanes
        else:
            name = _auto_backend(shape, dtype_s, axis, device_type)
            if name == "cuda_fused" and not kernels_take(compute_dtype, accum_dtype, precision):
                name = "mma_torch"
        # quarantine re-routes every auto choice, tuned winners included
        name = _dequarantine(name)
    return ReducePlan(
        backend=name,
        compute_dtype=compute_dtype,
        accum_dtype=accum_dtype,
        num_lanes=num_lanes,
        tiles_per_block=8 if tiles_per_block is None else tiles_per_block,
        precision=precision,
        kahan_block=4096 if kahan_block is None else kahan_block,
    )


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
    device=None,
) -> ReducePlan:
    """The plan for reducing ``shape``/``dtype`` over ``axis`` (the reduced
    extent, the dtype and the operand's ``device`` pick the auto backend;
    unset fields follow the reference: 8 tiles per block, native
    precision, Kahan blocks of 4096). ``segments=N`` marks a multi-reduce
    of N pieces (``shape`` is then the packed stream): on auto it routes
    to the "segmented" backend. Memoized (see the module doc)."""
    shape_t = tuple(int(d) for d in shape)
    return _plan_for_cached(
        shape_t, dtype_name(dtype), kind, _norm_axis(axis, len(shape_t)),
        backend if backend is not None else default_backend(),
        None if compute_dtype is None else dtype_name(compute_dtype),
        None if accum_dtype is None else dtype_name(accum_dtype),
        None if num_lanes is None else int(num_lanes),
        None if tiles_per_block is None else int(tiles_per_block),
        precision,
        None if kahan_block is None else int(kahan_block),
        None if segments is None else int(segments),
        _device_type(device),
    )


def plan_cache_info():
    """(hits, misses, maxsize, currsize) of the ``plan_for`` memo."""
    return _plan_for_cached.cache_info()


def plan_cache_clear(clear_tuned: bool = False) -> None:
    """Drop every memoized plan, reduce and scan (and, with
    ``clear_tuned``, the autotuned winners)."""
    _plan_for_cached.cache_clear()
    _scan_plan_cached.cache_clear()
    if clear_tuned:
        _TUNED.clear()


def segmented_backend_for(n: int, dtype, m: int = MXU, device=None, plan=None) -> str:
    """The executor of a segmented multi-reduce of ``n`` elements in all
    (the "segmented" backend's per-call choice, the reference's rules with
    "on a real TPU" read as "the operand lies on a CUDA device"): exact
    ``torch`` for non-float data and for n <= m; the kernels
    (``cuda_fused``) for streams of at least two m^2 tiles at m = 128 on a
    CUDA device, when the kernels read ``plan``'s dtypes
    (``kernels_take``); ``mma_torch`` otherwise. Quarantine applies."""
    if not _is_float(dtype) or n <= m:
        return "torch"
    on_card = device is not None and torch.device(device).type == "cuda"
    readable = plan is None or kernels_take(plan.compute_dtype, plan.accum_dtype, plan.precision)
    if on_card and readable and m == MXU and n >= _MIN_KERNEL_TILES * m * m:
        return _dequarantine("cuda_fused")
    return _dequarantine("mma_torch")


# ------------------------------- scan plans ----------------------------------


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one prefix sum runs (the reference's fields, ``num_lanes`` for
    ``num_cores``): backend ("torch": ``torch.cumsum`` at f32; "mma_torch":
    the batched triangular product; "cuda_fused" / "cuda_hier": the scan
    kernel for 1-D streams), the tile m, tiles per block and the lane count
    (the reference's striped geometry, 1 lane by default; the port's kernel
    runs one CTA per tile whatever they say, and ``hbm_bytes`` keeps the
    reference's model), and dtype names. The compute dtype
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


@functools.lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _scan_plan_cached(shape, dtype_s, name, m, tiles_per_block, num_lanes, compute_dtype,
                      device_type) -> ScanPlan:
    dtype = getattr(torch, dtype_s)
    m_ = MXU if m is None else m
    if name == "auto":
        name = _dequarantine(_auto_scan_backend(shape, dtype, m_, device_type))
    if compute_dtype is None:
        compute_dtype = dtype_s if native_ingest_dtype(dtype) else "float32"
    return ScanPlan(
        backend=name,
        m=m_,
        tiles_per_block=8 if tiles_per_block is None else tiles_per_block,
        num_lanes=1 if num_lanes is None else num_lanes,
        compute_dtype=compute_dtype,
        accum_dtype="float32",
    )


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
    operand's (auto picks the kernel only on a CUDA device). Memoized,
    keyed on the device type too; dropped with the reduce memo."""
    return _scan_plan_cached(
        tuple(int(d) for d in shape),
        dtype_name(getattr(torch, dtype) if isinstance(dtype, str) else dtype),
        backend if backend is not None else default_backend(),
        None if m is None else int(m),
        None if tiles_per_block is None else int(tiles_per_block),
        None if num_lanes is None else int(num_lanes),
        None if compute_dtype is None else dtype_name(compute_dtype),
        _device_type(device),
    )


def scan_plan_cache_info():
    """(hits, misses, maxsize, currsize) of the ``scan_plan_for`` memo."""
    return _scan_plan_cached.cache_info()


# ------------------------------- autotuning ----------------------------------

# What a planner or a kernel wrapper raises to refuse a candidate before
# anything is launched; autotune skips those candidates and nothing else.
_REFUSALS = (ValueError, TypeError, NotImplementedError)
_KERNEL_BACKENDS = ("cuda_fused", "cuda_hier")


def _default_lane_candidates(dev: torch.device) -> Tuple[int, ...]:
    """One, two and four CTAs per SM on a CUDA device; one lane on the CPU."""
    if dev.type != "cuda":
        return (1,)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return (sms, 2 * sms, 4 * sms)


def _elapsed_s(fn, dev: torch.device, repeats: int) -> float:
    """Best of ``repeats`` timed calls after one warm call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    best = math.inf
    for _ in range(max(1, repeats)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def autotune(
    shape: Sequence[int],
    dtype,
    *,
    kind: str = "sum",
    axis=None,
    segments: Optional[int] = None,
    backends: Optional[Sequence[str]] = None,
    tiles_per_block_candidates: Sequence[int] = (2, 4, 8, 16),
    lanes_candidates: Optional[Sequence[int]] = None,
    repeats: int = 3,
    seed: int = 0,
    device=None,
    timings: Optional[dict] = None,
) -> ReducePlan:
    """Time every candidate plan for one problem on ``device`` (the GPU
    unless the caller asks for the CPU) and record the fastest for later
    auto-selected ``plan_for`` calls on that device type (the reference's
    ``autotune``, ``num_lanes`` for ``num_cores``). The operand is seeded
    normal data drawn on the device (ones for non-float dtypes); with
    ``segments=N`` the timed call is ``reduce_many`` over the stream split
    into N pieces. The kernel
    backends sweep ``tiles_per_block_candidates``, and cuda_fused also
    ``lanes_candidates`` (default: 1, 2 and 4 CTAs per SM on the card, 1 on
    the CPU); every candidate gets one warm call and the best of
    ``repeats`` timed calls. ``timings``: a dict that gets ``{plan:
    seconds}`` of every candidate that ran. Returns the winner; the memos
    are dropped."""
    from repro_torch.reduce import api as _api  # deferred: api imports this module
    from repro_torch.reduce import backends as _backends

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; autotune times on the GPU unless it "
                           "is given device='cpu'")
    shape_t = tuple(int(d) for d in shape)
    axis_t = _norm_axis(axis, len(shape_t))
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if backends is None:
        backends = tuple(b for b in _backends.available_backends() if b != "segmented")
    lanes_all = (tuple(lanes_candidates) if lanes_candidates is not None
                 else _default_lane_candidates(dev))
    if dt.is_floating_point:
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape_t, generator=gen, device=dev).to(dt)
    else:
        x = torch.ones(shape_t, dtype=dt, device=dev)
    pieces = tuple(x.reshape(-1).tensor_split(segments)) if segments else None
    best, best_s = None, math.inf
    for name in backends:
        tpbs = tuple(tiles_per_block_candidates) if name in _KERNEL_BACKENDS else (None,)
        lanes = lanes_all if name == "cuda_fused" else (None,)
        for tpb in tpbs:
            for nl in lanes:
                try:
                    cand = plan_for(shape_t, dt, kind=kind, axis=axis_t, backend=name,
                                    tiles_per_block=tpb, num_lanes=nl, segments=segments,
                                    device=dev)
                    if segments:
                        def call(p=cand):
                            return _api.reduce_many(pieces, kind=kind, plan=p)
                    else:
                        def call(p=cand):
                            return _api.reduce(x, axis=axis_t, kind=kind, plan=p)
                    with torch.no_grad():
                        elapsed = _elapsed_s(call, dev, repeats)
                except _REFUSALS:
                    continue  # refused before launch; a launch failure propagates
                if timings is not None:
                    timings[cand] = elapsed
                if elapsed < best_s:
                    best, best_s = cand, elapsed
    if best is None:
        raise RuntimeError(f"autotune: no candidate ran for shape={shape_t} dtype={dt} "
                           f"kind={kind!r}")
    _TUNED[_problem_key(shape_t, dtype_name(dt), kind, axis_t, segments, dev.type)] = best
    plan_cache_clear()  # cached auto plans may now be stale
    return best
