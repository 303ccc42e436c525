"""Modality frontend stubs: the vision tower is upstream of the backbone.

Port of ``repro/models/frontends.py``'s ``synth_image_embeds``.
llama-3.2-vision-11b's ViT is not part of the assignment: the backbone
takes precomputed (B, n_img_tokens, d_model) patch embeddings, which the
interleaved cross-attention layers read. ``synth_image_embeds`` makes a
deterministic stand-in from an explicit ``torch.Generator`` (the
reference's takes a JAX key): standard normal values drawn at f32 and cast
to the model's dtype. The audio family's codebook tokens come with it.
"""

from __future__ import annotations

import torch


def synth_image_embeds(gen: torch.Generator, batch: int, n_tokens: int, d_model: int,
                       dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return torch.randn((batch, n_tokens, d_model), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)
