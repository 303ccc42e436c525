"""llama-3.2-vision-11b [vlm] -- cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

40L d_model=4096, 32 heads on 8 kv heads (GQA) of 128, d_ff=14336,
vocab=128256 (untied head), rope theta 500000. Cross-attention layers
interleaved one in five (8 of 40); the ViT frontend is a stub: the context
is (B, 1032, d_model) patch embeddings (``models.frontends.
synth_image_embeds``). 9.77 B parameters: it serves on one card and trains
there only cut in depth (``launch.train.check_fits_card``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    norm="rmsnorm",
    n_img_tokens=1032,  # a 1025-token tile, padded to a multiple of 8
    rope_theta=500000.0,
)

TINY = ModelConfig(
    name="llama32v-tiny",
    family="vlm",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    norm="rmsnorm",
    n_img_tokens=16,
    dtype="float32",
)
