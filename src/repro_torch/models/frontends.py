"""Modality frontend stubs: the vision tower and the audio tokenizer are
upstream of the backbone.

Port of ``repro/models/frontends.py``. llama-3.2-vision-11b's ViT is not
part of the assignment: the backbone takes precomputed (B, n_img_tokens,
d_model) patch embeddings, which the interleaved cross-attention layers
read. musicgen-medium's EnCodec tokenizer is upstream too: the model reads
the (B, S, n_codebooks) token grid itself, and its "frontend" is the
codebook sum of ``models.model._embed``. ``synth_image_embeds`` and
``synth_codebook_tokens`` make deterministic stand-ins from an explicit
``torch.Generator`` (the reference's take a JAX key): standard normal
values drawn at f32 and cast to the model's dtype; int32 tokens drawn
uniformly from [0, vocab).
"""

from __future__ import annotations

import torch


def synth_image_embeds(gen: torch.Generator, batch: int, n_tokens: int, d_model: int,
                       dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return torch.randn((batch, n_tokens, d_model), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def synth_codebook_tokens(gen: torch.Generator, batch: int, seq: int, n_books: int,
                          vocab: int, device="cpu") -> torch.Tensor:
    return torch.randint(0, vocab, (batch, seq, n_books), generator=gen, dtype=torch.int32,
                         device=device)
