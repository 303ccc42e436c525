"""granite-moe-1b-a400m [moe] -- 32 experts top-8, fine-grained (d_ff=512).
[hf:ibm-granite/granite-3.0-1b-a400m-base]

24L d_model=1024 16H (GQA kv=8) of 64, d_ff=512 per expert, vocab=49155
(padded to 49408), tied embeddings, RMSNorm: 1.335 B parameters, 0.429 B
active per token.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,
    vocab_size=49155,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="granite-moe-tiny",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=0,
    vocab_size=256,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=16, capacity_factor=2.0),
    tie_embeddings=True,
    dtype="float32",
)
