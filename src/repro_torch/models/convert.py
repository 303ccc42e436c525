"""Carry the reference's parameters across: numpy tree -> port parameters.

``params_from_jax`` takes the tree that ``repro.models.init_params``
returns, already converted to numpy arrays by the caller (this package
never imports jax), and returns the port's parameter dict. The reference
stacks unit parameters on a leading ``n_units`` axis (for ``lax.scan``);
here each layer becomes its own entry, whatever its kind (an attention
block, global or local, with an MLA mixer or an MoE FFN, a cross-attention
block with its 0-d gate, a Mamba-2 or an RG-LRU block), a partial tail unit
(recurrentgemma's 38 = 12 x 3 + 2) follows the units, and every leaf
keeps the reference's dtype (the SSM's f32 ``dt_bias``, ``A_log`` and ``D``
and the RG-LRU's f32 ``lam`` in a bf16 model stay f32). bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses, so they
cross as their raw 16-bit patterns and are reinterpreted: bitwise exact.
An audio arch's (K, vocab, d) codebook table, its (K, d, padded vocab)
heads and its LayerNorms' biases cross like any other leaf.

``reference_leaf_groups`` maps the port's optimizer leaves onto the
reference's: the reference keeps one leaf per stacked unit position (8 for
olmo: the embedding and 7 weights stacked over 16 layers), the port one
per layer (113; 219 for internlm2-1.8b, whose untied head is one leaf
on both sides; 484 on 14 for musicgen-medium, whose codebook table and
heads are one leaf each and whose LayerNorms are two). Optimizer state
kept per leaf -- the fused second moment's scalar ``v`` -- must be kept
per REFERENCE leaf for the two packages to take the same update.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor with the same bits and shape (bf16 via an
    int16 view; a 0-d array, such as a cross-attention gate, stays 0-d)."""
    shape = np.shape(a)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.reshape(shape).to(device)


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
    params = {
        "embed": _convert(np_tree["embed"], device),
        "layers": layers,
        "final_norm": _convert(np_tree["final_norm"], device),
    }
    if "head" in np_tree:  # an untied head
        params["head"] = _convert(np_tree["head"], device)
    return params


def _leaf_paths(tree, prefix=()):
    """Key paths of a nested dict / list of tensors in ``reduce.tree_leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, sub in enumerate(tree) for p in _leaf_paths(sub, prefix + (i,))]
    return [prefix]


def reference_leaf_groups(params: dict, cfg) -> tuple:
    """For each leaf of the port's ``params`` (in ``tree_leaves`` order),
    the index of the reference leaf it belongs to, in the reference's
    flatten order. Layer ``u * P + j`` (P = pattern length) sits in the
    stacked leaf ``units/pos{j}/...``, a tail layer in ``tail/pos{j}/...``."""
    pat = len(cfg.block_pattern)
    n_units = cfg.n_layers // pat
    ref_paths = []
    for path in _leaf_paths(params):
        if path[0] == "layers":
            layer, rest = path[1], path[2:]
            unit = ("units", f"pos{layer % pat}") if layer < n_units * pat else (
                "tail", f"pos{layer - n_units * pat}")
            path = unit + rest
        ref_paths.append(tuple(str(k) for k in path))
    order = {p: i for i, p in enumerate(sorted(set(ref_paths)))}
    return tuple(order[p] for p in ref_paths)
