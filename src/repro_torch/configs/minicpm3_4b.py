"""minicpm3-4b [dense] -- Multi-head Latent Attention. [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H d_ff=6400 vocab=73448 (padded to 73472), MLA with
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64
(official config), SwiGLU, RMSNorm, untied head: 4.26 B parameters. The
KV cache holds the compressed latent, 256 + 32 values a token a layer.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    norm="rmsnorm",
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64
    ),
)

TINY = ModelConfig(
    name="minicpm3-tiny",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=24,
    d_ff=128,
    vocab_size=256,
    norm="rmsnorm",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    dtype="float32",
)
