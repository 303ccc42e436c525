"""musicgen-medium [audio] -- a decoder over EnCodec tokens.
[arXiv:2306.05284]

48L d_model=1536 24H (kv=24: MHA) of 64, d_ff=6144 with GELU, vocab=2048,
LayerNorm with scale and bias, 4 codebook streams. The EnCodec tokenizer
and its delay pattern are upstream of the backbone: the model reads the
(B, S, 4) token grid, sums the four streams' embeddings, and emits one
untied head a stream, (B, S, 4, vocab) logits.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    ffn_kind="gelu",
    n_codebooks=4,
)

TINY = ModelConfig(
    name="musicgen-tiny",
    family="audio",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=64,
    norm="layernorm",
    ffn_kind="gelu",
    n_codebooks=4,
    dtype="float32",
)
