"""Shape-only stand-ins for every (arch x shape) cell: tensors on the meta
device, never allocated.

Port of ``repro/launch/specs.py``: the reference's ``ShapeDtypeStruct``
trees become meta tensors (``init_params``, ``optim.init_state`` and
``make_caches`` run on ``torch.device("meta")``), so the dry run
(``launch.dryrun``) sizes a 132B model's step without a byte of parameter
memory.
"""

from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.models import make_caches
from repro_torch.models.model import init_params, param_axes, param_dtype

META = torch.device("meta")


def microbatches_for(cfg, shape, data_degree: int = 16) -> int:
    """Gradient-accumulation depth: ~1-2 sequences per rank per
    microbatch (the reference's choice: 16 for dbrx, 4 under 3B
    parameters, 8 at d_model >= 4096 or 48+ layers, else 2), capped by
    the batch per data rank, and lowered until each microbatch divides by
    the data-parallel degree."""
    if shape.mode != "train":
        return 1
    if cfg.name.startswith("dbrx"):
        want = 16
    elif cfg.param_count() < 3e9:
        want = 4
    elif cfg.d_model >= 4096 or cfg.n_layers >= 48:
        want = 8
    else:
        want = 2
    cap = max(1, shape.global_batch // data_degree)
    micro = min(want, cap)
    while shape.global_batch % micro or (shape.global_batch // micro) % data_degree:
        micro -= 1  # terminates at 1
    return micro


def param_specs(cfg):
    """(meta parameter tree, logical axes tree): no allocation."""
    return init_params(cfg, torch.Generator().manual_seed(0), META), param_axes(cfg)


def opt_specs(param_shapes, *, fused_second_moment: bool = False):
    """AdamW's state for meta parameters, on the meta device."""
    return optim.init_state(param_shapes, fused_second_moment=fused_second_moment)


def batch_specs(cfg, shape) -> dict:
    """Train/prefill batch inputs: tokens (GB, S) ((GB, S, K) with K
    codebook streams) and, for a cross-attention arch, the context."""
    gb, s = shape.global_batch, shape.seq_len
    tok_shape = (gb, s, cfg.n_codebooks) if cfg.n_codebooks else (gb, s)
    out = {"tokens": torch.empty(tok_shape, dtype=torch.int32, device=META)}
    if cfg.n_img_tokens:
        out["image_embeds"] = torch.empty((gb, cfg.n_img_tokens, cfg.d_model),
                                          dtype=param_dtype(cfg), device=META)
    return out


def decode_specs(cfg, shape) -> dict:
    """(token, caches, pos) stand-ins for one decode step at kv_len =
    seq_len."""
    gb, s_max = shape.global_batch, shape.seq_len
    tok_shape = (gb, 1, cfg.n_codebooks) if cfg.n_codebooks else (gb, 1)
    return {"token": torch.empty(tok_shape, dtype=torch.int32, device=META),
            "caches": make_caches(cfg, gb, s_max, META),
            "pos": torch.empty((), dtype=torch.int32, device=META)}


def input_specs(cfg, shape) -> dict:
    """Every abstract input of the cell's step function."""
    if shape.mode in ("train", "prefill"):
        return batch_specs(cfg, shape)
    return decode_specs(cfg, shape)
