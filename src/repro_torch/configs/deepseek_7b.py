"""deepseek-7b [dense] -- llama-arch reference dense model. [arXiv:2401.02954]

30L d_model=4096 32H (GQA kv=32 -> MHA) d_ff=11008 vocab=102400. RMSNorm
with a scale and an untied head.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=102400,
    norm="rmsnorm",
)

TINY = ModelConfig(
    name="deepseek-tiny",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    vocab_size=256,
    norm="rmsnorm",
    dtype="float32",
)
