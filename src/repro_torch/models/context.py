"""Activation-sharding context.

Port of ``repro/models/context.py``. The reference pins the layout of the
(batch, seq, d_model) activations here before tracing, so that GSPMD keeps
the batch on the data axes; ``constrain`` is a no-op when nothing is set.

Here every rank is a process that holds only its own rows, so there is no
layout to pin: the context records the mesh, the batch dim's spec entry
and the rank's row count, and ``constrain`` CHECKS that a (B, S, d)
activation holds the rank's rows (it raises otherwise) and returns it
unchanged. ``constrain_moe_dispatch`` checks the (B, E, C, d) dispatch
block the same way: the rank's rows and, where the experts split over
"model", its experts only.

``shard_map_specs`` has no region to open: a rank's function already runs
on its own blocks, so with a context set it returns ``fn`` itself (the
specs are not used), and None without one, as the reference's does.

  set_activation_sharding(mesh, spec, rows)   pin (or clear, with None)
  activation_sharding(mesh, spec, rows)       the same for a block
  get_activation_sharding()                   the pinned ActivationSharding
  batch_axis_entry()                          the batch dim's spec entry
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch


class ActivationSharding(NamedTuple):
    """The reference's ``NamedSharding`` of the activations: the mesh, the
    spec of a (B, S, d) activation, and the rows a rank holds (None: not
    checked)."""

    mesh: object
    spec: tuple
    rows: Optional[int] = None


_ACT_SHARDING: Optional[ActivationSharding] = None


def set_activation_sharding(mesh, spec: tuple = (), rows: Optional[int] = None) -> None:
    """Pin the activations' layout (``mesh=None`` clears it)."""
    global _ACT_SHARDING
    _ACT_SHARDING = None if mesh is None else ActivationSharding(mesh, tuple(spec), rows)


def get_activation_sharding() -> Optional[ActivationSharding]:
    return _ACT_SHARDING


@contextlib.contextmanager
def activation_sharding(mesh, spec: tuple = (), rows: Optional[int] = None):
    """``set_activation_sharding`` for the block, the earlier context
    restored after it."""
    global _ACT_SHARDING
    prev = _ACT_SHARDING
    set_activation_sharding(mesh, spec, rows)
    try:
        yield
    finally:
        _ACT_SHARDING = prev


def batch_axis_entry():
    """The spec entry of the batch dim (None if unsharded or unset)."""
    if _ACT_SHARDING is None:
        return None
    return _ACT_SHARDING.spec[0] if len(_ACT_SHARDING.spec) else None


def _check_rows(t: torch.Tensor, what: str) -> None:
    rows = _ACT_SHARDING.rows
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{what} of shape {tuple(t.shape)} holds {t.shape[0]} batch rows; "
                         f"this rank's share is {rows}")


def constrain(h: torch.Tensor) -> torch.Tensor:
    """A (B, S, d) activation, checked to hold the rank's batch rows."""
    if _ACT_SHARDING is None or h.ndim != 3:
        return h
    _check_rows(h, "an activation")
    return h


def _model_degree() -> int:
    mesh = _ACT_SHARDING.mesh
    return mesh.axis_size("model") if "model" in mesh.axis_names else 1


def constrain_moe_dispatch(t: torch.Tensor, n_experts: Optional[int] = None) -> torch.Tensor:
    """The (B, E, C, d) expert-dispatch block, checked: the rank's rows,
    and E / model experts where ``n_experts`` (the model's count) splits
    over "model" (expert parallelism)."""
    if _ACT_SHARDING is None or t.ndim != 4:
        return t
    _check_rows(t, "the dispatch block")
    m = _model_degree()
    if n_experts is not None and n_experts % m == 0 and t.shape[1] != n_experts // m:
        raise ValueError(f"the dispatch block holds {t.shape[1]} experts; under expert "
                         f"parallelism over {m} ranks a rank holds {n_experts // m}")
    return t


def shard_map_specs(fn, in_specs, out_specs):
    """``fn`` itself under a context (each rank already runs it on its own
    blocks), None without one."""
    del in_specs, out_specs
    return None if _ACT_SHARDING is None else fn


def data_degree() -> int:
    """Ranks the batch is split over (1 without a context)."""
    entry = batch_axis_entry()
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(_ACT_SHARDING.mesh.axis_size(ax) for ax in axes)


def model_degree() -> int:
    """Ranks of the "model" axis (1 without a context)."""
    return 1 if _ACT_SHARDING is None else _model_degree()
