"""Carry the reference's parameters across: numpy tree -> port parameters.

``params_from_jax`` takes the tree that ``repro.models.init_params``
returns, already converted to numpy arrays by the caller (this package
never imports jax), and returns the port's parameter dict. The reference
stacks unit parameters on a leading ``n_units`` axis (for ``lax.scan``);
here each layer becomes its own entry. bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses, so they
cross as their raw 16-bit patterns and are reinterpreted: bitwise exact.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor with the same bits (bf16 via an int16 view)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _convert(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree) if index is None else np.asarray(tree)[index]
    return tensor_from_numpy(a, device)


def params_from_jax(np_tree: dict, cfg, device="cpu") -> dict:
    """The reference's ``init_params`` tree (as numpy) -> port parameters.
    Layer ``u * P + j`` is unit ``u``'s block ``pos{j}`` (P = pattern
    length); tail blocks follow."""
    pat = tuple(cfg.block_pattern)
    n_units = cfg.n_layers // len(pat)
    layers = []
    for u in range(n_units):
        for j in range(len(pat)):
            layers.append(_convert(np_tree["units"][f"pos{j}"], device, index=u))
    for j in range(cfg.n_layers % len(pat)):
        layers.append(_convert(np_tree["tail"][f"pos{j}"], device))
    return {
        "embed": _convert(np_tree["embed"], device),
        "layers": layers,
        "final_norm": _convert(np_tree["final_norm"], device),
    }
