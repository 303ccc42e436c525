"""The launch meter: the zero-copy contract audited on eager calls.

The stand-in for ``repro/reduce/inspect.py``, which walks lowered jaxprs;
the port runs eagerly, so each audit here RUNS ``fn(*args)`` and watches it:

  * the kernel wrappers (``kernels.common.counted``) note every call that
    did their kernel's work -- a launch on the card, which is where its
    ``launches`` counter rises, or the plain version on CPU tensors -- with
    the bytes the launch reads and writes (``common.record_io``);
    ``launch_records``, ``count_kernel_launches`` and ``measured_hbm_bytes``
    read those notes. They are the kernels' ctypes calls, which PyTorch's
    dispatcher never sees.
  * the aten ops OUTSIDE every wrapper go through a ``TorchDispatchMode``:
    ``staging_ops`` finds the stream-sized casts, copies, pads and
    concatenations the zero-copy contract forbids, ``epilogue_ops`` the
    scalar finishers (sqrt, div, min, max) an in-launch chain removes, and
    ``census_ops`` the host NaN/Inf sweeps and selects the in-launch census
    removes. A wrapper marks its body as inside the kernel: its plain
    version runs there on the CPU, so its casts are the kernel's work, as
    ops inside a ``pallas_call`` are in the reference.

``measured_hbm_bytes`` is the counterpart of the reference's
``pallas_io_bytes`` plus staged bytes: it equals ``ReducePlan.hbm_bytes(...)
.launch_io`` for the launches the model describes byte for byte (the
hierarchy's levels, the parts kernel, a fused kernel's one-lane finish;
see ``ReducePlan.hbm_bytes`` for the multi-lane fused kernels).

  * the collectives (``torch.distributed``'s c10d ops, which do pass
    through the dispatcher) go through the same kind of mode:
    ``collective_eqns`` lists every one a call runs, with its bytes, and
    ``collective_recv_bytes`` sums what its all-gathers bring into the
    rank -- the measured side of ``core.cost_model.interconnect_bytes``,
    as ``measured_hbm_bytes`` is of ``ReducePlan.hbm_bytes``.

Metering never changes what a call does: errors propagate.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import common

# aten ops that materialize a staging copy when they run at stream size
# outside a kernel: the casts (``.to``), copies into a buffer, pads and
# concatenations (the reference's convert_element_type, pad, concatenate).
STAGING_OPS = ("_to_copy", "copy_", "constant_pad_nd", "cat")
# Host-side elementwise prologue passes (the reference's PROLOGUE_PRIMITIVES):
# pass as ``extra`` to audit a forward mapped reduction.
PROLOGUE_OPS = ("mul", "pow", "sign", "abs")
# Scalar finishers an in-launch epilogue chain removes (any size).
EPILOGUE_OPS = ("sqrt", "rsqrt", "div", "reciprocal", "minimum", "maximum", "clamp",
                "clamp_min", "clamp_max", "min", "max")
# Host NaN/Inf sweeps and masked selects the in-launch census removes.
# ``torch.isfinite`` decomposes before the dispatcher reaches a mode (x == x
# and |x| != inf), so the comparisons stand for it.
CENSUS_OPS = ("isfinite", "isnan", "isinf", "eq", "ne", "where")


def _elems(out) -> int:
    ts = out if isinstance(out, (list, tuple)) else (out,)
    return max((t.numel() for t in ts if isinstance(t, torch.Tensor)), default=0)


def _bytes(out) -> int:
    ts = out if isinstance(out, (list, tuple)) else (out,)
    return sum(common.nbytes(t) for t in ts if isinstance(t, torch.Tensor))


class _OpWatch(TorchDispatchMode):
    """Records ``(op name, out elems, out bytes)`` for every aten op named in
    ``names`` that runs outside every kernel wrapper."""

    def __init__(self, names):
        super().__init__()
        self.names = frozenset(names)
        self.found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.names and not common.inside_wrapper():
            self.found.append((name, _elems(out), _bytes(out)))
        return out


def _watch(names, fn, args, kwargs):
    with _OpWatch(names) as w:
        out = fn(*args, **kwargs)
    return out, w.found


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _largest(args) -> int:
    return max((t.numel() for t in _tensors(args)), default=1)


# --------------------------------- collectives ---------------------------------

# c10d ops of torch.distributed as the dispatcher names them (the
# reference's COLLECTIVE_PRIMITIVES: all_gather, psum, ppermute, ...).
COLLECTIVE_OPS = ("allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_",
                  "allreduce_", "allreduce_coalesced_", "broadcast_", "reduce_scatter_",
                  "_reduce_scatter_base_", "alltoall_", "alltoall_base_", "send", "recv_",
                  "recv_any_source_")
_GATHERS = ("allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_")


def _tensor_bytes(tree) -> int:
    return sum(common.nbytes(t) for t in _tensors(tree))


class _CollectiveWatch(TorchDispatchMode):
    """Records ``(c10d op, bytes in, bytes out)`` for every collective a
    call runs: an all-gather brings in its output less its input, a send
    puts out its tensors, a receive takes them in, an all-reduce does both."""

    def __init__(self):
        super().__init__()
        self.found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in COLLECTIVE_OPS:
            if name in _GATHERS:
                inb, outb = _tensor_bytes(args[1]), _tensor_bytes(args[0])
            elif name == "send":
                inb, outb = _tensor_bytes(args[0]), 0
            elif name.startswith("recv"):
                inb, outb = 0, _tensor_bytes(args[0])
            else:
                inb = outb = _tensor_bytes(args[0])
            self.found.append((name, inb, outb))
        return out


def collective_eqns(fn, *args, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)``: ``[(c10d op, bytes in, bytes out), ...]``
    for every collective it ran, in order (the reference's
    ``collective_eqns`` of a lowered program)."""
    with _CollectiveWatch() as w:
        fn(*args, **kwargs)
    return list(w.found)


def collective_recv_bytes(fn, *args, **kwargs) -> int:
    """Bytes that ``fn(*args, **kwargs)``'s all-gathers brought into this
    rank: each gather's output holds the rank's own row and P - 1 others,
    so output less input is what crossed the wire. Held equal to
    ``cost_model.interconnect_bytes(slots, world).recv_per_device``."""
    return sum(out - inb for name, inb, out in collective_eqns(fn, *args, **kwargs)
               if name in _GATHERS)


# ----------------------------- the launch notes -------------------------------


@contextlib.contextmanager
def _meter():
    records = common.open_meter()
    try:
        yield records
    finally:
        common.close_meter(records)


def launch_records(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``: ``(its result, [LaunchRecord, ...])``,
    one record per wrapper call that did its kernel's work, in order."""
    with _meter() as records:
        out = fn(*args, **kwargs)
    return out, list(records)


def count_kernel_launches(fn, *args, include_plain: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)``: ``(its result, {kernel name: launches})``
    for every kernel wrapper, from its ``launches`` counter, set to 0 just
    before and read just after. A wrapper that ran its plain version in
    its kernel's place (CPU operands) launched nothing, and the call raises
    after ``fn`` returns -- unless ``include_plain``: then those calls are
    counted as well, which is the CPU tests' view, where no kernel
    launches."""
    common.reset_launches()
    out, records = launch_records(fn, *args, **kwargs)
    counts = common.launch_counts()
    plain = collections.Counter(r.kernel for r in records if r.route == "plain")
    if plain and not include_plain:
        raise RuntimeError(f"launch meter: plain versions ran in place of kernels (CPU "
                           f"operands): {dict(plain)}")
    return out, {name: n + plain.get(name, 0) for name, n in counts.items()}


def measured_hbm_bytes(fn, *args, min_elems: int = 0, **kwargs) -> int:
    """Bytes one call moves across its launches (every launch's operands and
    outputs, as noted by the wrappers) plus the bytes of the staging ops of
    at least ``min_elems`` elements outside them: a staged path is charged
    for its copies, a zero-copy path is not."""
    with _meter() as records:
        _, staged = _watch(STAGING_OPS, fn, args, kwargs)
    return (sum(r.io_bytes for r in records)
            + sum(b for _, e, b in staged if e >= max(min_elems, 1)))


# ------------------------------- the audits -----------------------------------


def staging_ops(fn, *args, min_elems: int | None = None, extra: tuple = (), **kwargs) -> list:
    """``[(op, out elems, out bytes), ...]``: the staging ops (``STAGING_OPS``
    and ``extra``, e.g. ``PROLOGUE_OPS``) of at least ``min_elems`` elements
    (default: the largest tensor argument's) that ran outside every kernel
    wrapper during ``fn(*args, **kwargs)``; empty when the call never cast,
    copied, padded or concatenated a stream-sized buffer around its
    kernels."""
    floor = _largest(args) if min_elems is None else min_elems
    _, found = _watch(STAGING_OPS + tuple(extra), fn, args, kwargs)
    return [f for f in found if f[1] >= floor]


def assert_staging_free(fn, *args, min_elems: int | None = None, extra: tuple = (),
                        **kwargs) -> None:
    """Fail if ``fn(*args, **kwargs)`` ran a stream-sized staging op outside
    its kernels (see ``staging_ops``)."""
    bad = staging_ops(fn, *args, min_elems=min_elems, extra=extra, **kwargs)
    if bad:
        raise AssertionError(f"zero-copy contract violated: stream-sized staging ops outside "
                             f"the kernel wrappers: {bad}")


def epilogue_ops(fn, *args, ops: tuple = EPILOGUE_OPS, **kwargs) -> list:
    """``[(op, out elems), ...]``: the scalar finishers (any size) that ran
    outside every kernel wrapper."""
    _, found = _watch(ops, fn, args, kwargs)
    return [(name, elems) for name, elems, _ in found]


def assert_epilogue_free(fn, *args, ops: tuple = EPILOGUE_OPS, **kwargs) -> None:
    """Fail if a sqrt/div/min/max ran outside the kernels: the one-launch
    statistic's finish belongs in its launch. Only for calls whose whole
    scalar tail should be in-launch (the optimizer's norm and clip)."""
    bad = epilogue_ops(fn, *args, ops=ops, **kwargs)
    if bad:
        raise AssertionError(f"epilogue contract violated: scalar finishers outside the "
                             f"kernels: {bad}")


def census_ops(fn, *args, min_elems: int = 1, ops: tuple = CENSUS_OPS, **kwargs) -> list:
    """``[(op, out elems), ...]``: host NaN/Inf sweeps and selects of at
    least ``min_elems`` elements outside every kernel wrapper."""
    _, found = _watch(ops, fn, args, kwargs)
    return [(name, elems) for name, elems, _ in found if elems >= min_elems]


def assert_census_free(fn, *args, min_elems: int = 1, ops: tuple = CENSUS_OPS,
                       **kwargs) -> None:
    """Fail if a NaN/Inf sweep or select ran outside the kernels: the census
    rides the reduction launch. Only for the statistic itself: model code
    and the guarded write-back select legitimately."""
    bad = census_ops(fn, *args, min_elems=min_elems, ops=ops, **kwargs)
    if bad:
        raise AssertionError(f"census contract violated: NaN/Inf sweeps outside the kernels: "
                             f"{bad}")

