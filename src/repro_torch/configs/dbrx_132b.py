"""dbrx-132b [moe] -- 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) of 128, d_ff=10752 per expert,
vocab=100352, untied head, RMSNorm: 131.6 B parameters (~36 B active),
263 GB at bf16 -- more than one card holds. The serving entry refuses it
at full depth (``launch.serve.serve_state_bytes``); its full width runs on
one card cut in depth (two layers take ~15.5 GB). Full depth waits for the
ROADMAP's sharding item.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab_size=100352,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

TINY = ModelConfig(
    name="dbrx-tiny",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=0,
    vocab_size=256,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=48, capacity_factor=2.0),
    dtype="float32",
)
