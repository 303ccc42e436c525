"""Shared kernel utilities: prologue/epilogue chains, tile helpers, the
device rule and the per-kernel launch counters.

A copy of the chain semantics of ``repro/kernels/common.py`` in torch. The
same chain definitions run host-side (the plain versions and the non-kernel
backends) and, encoded by ``encode_epilogue``, inside the CUDA kernels.

Device rule, shared by every kernel wrapper: a wrapper given CPU tensors
runs its plain PyTorch version; given CUDA tensors it launches its kernel
or raises. There is no fallback from one to the other.

Gradient rule: a wrapper called with grad mode on and an input that
requires grad either goes through its ``torch.autograd.Function`` or
raises (``refuse_grad``); it never returns an output cut from the graph.
"""

from __future__ import annotations

import torch

MXU = 128  # the paper's tile size m, kept from the reference for 1:1 layouts

# Dtypes the kernels read straight from the caller's buffer; anything else
# (f64, ints, bools) is cast to f32 first -- one staging copy.
NATIVE_INGEST_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def native_ingest_dtype(dtype) -> bool:
    """True when the kernels read this dtype in place."""
    return dtype in NATIVE_INGEST_DTYPES

# In-kernel elementwise prologues: the per-element map applied after the
# compute cast and the tail mask, before the reduction. "moments" is the
# paired (x, x^2) dual accumulator (structural, not a single map).
PROLOGUES = ("identity", "square", "abs", "moments")
ELEMENTWISE_PROLOGUES = ("identity", "square", "abs")


def check_prologue(prologue: str) -> str:
    if prologue not in PROLOGUES:
        raise ValueError(
            f"unknown prologue {prologue!r}; expected one of {PROLOGUES}"
        )
    return prologue


def normalize_part_prologues(prologue, nseg: int) -> tuple:
    """One validated prologue name per part, from a uniform string or a
    sequence."""
    if isinstance(prologue, str):
        return (check_prologue(prologue),) * nseg
    pros = tuple(check_prologue(p) for p in prologue)
    if len(pros) != nseg:
        raise ValueError(f"got {len(pros)} part prologues for {nseg} parts")
    return pros


def apply_prologue(x: torch.Tensor, prologue: str) -> torch.Tensor:
    """Elementwise prologue at the operand's precision (identity adds no
    op). Zero is a fixed point of every map, so masked lanes stay zero."""
    if prologue == "identity":
        return x
    if prologue == "square":
        return x * x
    if prologue == "abs":
        return torch.abs(x)
    raise ValueError(
        f"prologue {prologue!r} is not elementwise; expected one of "
        f"{ELEMENTWISE_PROLOGUES}"
    )


# Scalar EPILOGUES: the post-combine chain applied to a reduced f32 value.
# A chain is a tuple of ``(name, *float_params)`` steps.
EPILOGUES = ("identity", "sqrt", "scale", "rsqrt", "add_eps", "clip_coeff")

_EPILOGUE_ARITY = {
    "identity": (0,),
    "sqrt": (0,),
    "scale": (1,),        # scale(a): t * a
    "rsqrt": (0, 1),      # rsqrt(eps=0): 1 / sqrt(t + eps)
    "add_eps": (1,),      # add_eps(eps): t + eps
    "clip_coeff": (1, 2),  # clip_coeff(max_norm, eps=0): min(1, max/max(t,eps))
}

# Op codes of the CUDA kernels' epilogue interpreter (csrc/parts_reduce.cu).
EPILOGUE_OPCODES = {"sqrt": 0, "scale": 1, "rsqrt": 2, "add_eps": 3,
                    "clip_coeff": 4}


def _normalize_step(step) -> tuple:
    if isinstance(step, str):
        step = (step,)
    step = tuple(step)
    if not step or not isinstance(step[0], str):
        raise ValueError(f"epilogue step must start with a name: {step!r}")
    name, params = step[0], step[1:]
    if name not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {name!r}; expected one of {EPILOGUES}"
        )
    if len(params) not in _EPILOGUE_ARITY[name]:
        raise ValueError(
            f"epilogue {name!r} takes {_EPILOGUE_ARITY[name]} parameter(s); "
            f"got {step!r}"
        )
    return (name,) + tuple(float(p) for p in params)


def normalize_epilogue(spec) -> tuple:
    """Canonical hashable chain: ``None`` / ``"identity"`` / ``()`` -> the
    empty chain; a name or a ``(name, *params)`` step; or a tuple of steps.
    """
    if spec is None or spec == "identity" or spec == ():
        return ()
    if isinstance(spec, str):
        steps = (spec,)
    elif isinstance(spec, tuple) and spec and isinstance(spec[0], str):
        steps = (spec,)
    else:
        steps = tuple(spec)
    chain = tuple(_normalize_step(s) for s in steps)
    return tuple(s for s in chain if s[0] != "identity")


def normalize_epilogue_fork(spec) -> tuple:
    """A Python list marks a fork: ``[chain_a, chain_b]`` -> one chain per
    output scalar. Anything else is a single chain."""
    if isinstance(spec, list):
        if not spec:
            raise ValueError("an epilogue fork needs at least one chain")
        return tuple(normalize_epilogue(c) for c in spec)
    return (normalize_epilogue(spec),)


def apply_epilogue(t: torch.Tensor, chain: tuple) -> torch.Tensor:
    """Evaluate a chain on a reduced f32 tensor (every step is elementwise).
    """
    for step in chain:
        name, params = step[0], step[1:]
        if name == "sqrt":
            t = torch.sqrt(t)
        elif name == "scale":
            t = t * params[0]
        elif name == "rsqrt":
            eps = params[0] if params else 0.0
            t = 1.0 / torch.sqrt(t + eps)
        elif name == "add_eps":
            t = t + params[0]
        elif name == "clip_coeff":
            max_norm = params[0]
            eps = params[1] if len(params) > 1 else 0.0
            t = torch.clamp_max(max_norm / torch.clamp_min(t, eps), 1.0)
        elif name != "identity":  # pragma: no cover - normalize_* rejects
            raise ValueError(f"unknown epilogue {name!r}")
    return t


def encode_epilogue(chain: tuple) -> list:
    """A normalized chain -> ``[(opcode, p0, p1), ...]`` for the kernels."""
    out = []
    for step in chain:
        name, params = step[0], tuple(step[1:])
        if name == "rsqrt" and not params:
            params = (0.0,)
        if name == "clip_coeff" and len(params) == 1:
            params = params + (0.0,)
        params = params + (0.0,) * (2 - len(params))
        out.append((EPILOGUE_OPCODES[name],) + params)
    return out


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even) and lifted back to f32:
    where the kernels round an MMA operand."""
    return x.to(torch.bfloat16).to(torch.float32)


def triu_tile(m: int, dtype=torch.float32, k: int = 0, device=None) -> torch.Tensor:
    """Upper-triangular ones (m, m), ones where col >= row + k: the scan's
    prefix operand (x @ U turns each row into its running prefix; ``k=1``,
    strictly upper, gives the exclusive prefix)."""
    return torch.triu(torch.ones((m, m), dtype=dtype, device=device), diagonal=k)


def tril_tile(m: int, dtype=torch.float32, k: int = 0, device=None) -> torch.Tensor:
    """Lower-triangular ones (m, m), ones where col <= row + k; ``k=-1``
    (strict) is the scan's carry-down operand: Ls @ T1 gives, in row i, the
    fold of the rows before i."""
    return torch.tril(torch.ones((m, m), dtype=dtype, device=device), diagonal=k)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


# ------------------------- device rule and counters --------------------------


def on_cpu(*tensors: torch.Tensor) -> bool:
    """The device rule: True when every tensor lies on the CPU (run the
    plain version), False when every tensor lies on a CUDA device (launch
    the kernel). Anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return False
    raise ValueError(
        f"kernel operands must all be on the CPU or all on one CUDA device; "
        f"got {sorted(kinds)}"
    )


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    )


def refuse_grad(name: str, *tensors, entry: str | None) -> None:
    """A wrapper whose kernel writes a fresh output through ctypes has no
    ``grad_fn``: called on inputs that need a gradient it would cut the
    graph without a word. Such wrappers raise instead and name the
    differentiable entry point, or say that there is none (``entry=None``:
    the reference has no gradient either)."""
    if needs_grad(*tensors):
        hint = (f"Call {entry}, which differentiates through its own autograd Function, or "
                if entry else "It has no gradient (nor has the reference's kernel); ")
        raise RuntimeError(
            f"{name} is not differentiable: its input requires grad. {hint}"
            "run under torch.no_grad()"
        )


# Fold tickets: the integer counters by which a kernel's last CTA (or the
# last CTA of each row block) finds itself, and the scan's look-back words.
# One buffer per (kernel, device, stream), zeroed at first use and regrown,
# zeroed, when a launch needs more counters. The last CTA sets its ticket
# back to 0, and launches on one stream run in order, so each launch finds
# them zeroed. An epoch-tagged kernel (``epoch=True``) also gets a fresh
# epoch per launch, which tags the words it publishes, so the words of
# earlier launches read as unpublished and nothing is cleared between
# launches. Epochs run 1 .. 2^31 - 1; the buffer is zeroed again when they
# run out.
_TICKETS: dict = {}
_EPOCH_MAX = 2**31 - 1


def fold_tickets(kernel: str, dev: torch.device, stream: int, count: int = 1,
                 dtype: torch.dtype = torch.int32, epoch: bool = False):
    """The kernel's buffer of at least ``count`` counters of ``dtype``;
    with ``epoch``, ``(buffer, epoch)``: also the epoch this launch
    publishes under."""
    key = (kernel, dev.index, stream)
    have, last = _TICKETS.get(key, (None, 0))
    if have is None or have.numel() < count or last >= _EPOCH_MAX:
        have, last = torch.zeros((count,), dtype=dtype, device=dev), 0
    last += int(epoch)
    _TICKETS[key] = (have, last)
    return (have, last) if epoch else have


# Every kernel wrapper, by kernel name. Each wrapper carries ``launches``, a
# plain int that it increments where it launches its kernel and nowhere else.
KERNEL_WRAPPERS: dict = {}


def counted(name: str):
    """Register a kernel wrapper and give it a ``launches`` counter."""

    def wrap(fn):
        fn.launches = 0
        KERNEL_WRAPPERS[name] = fn
        return fn

    return wrap


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
