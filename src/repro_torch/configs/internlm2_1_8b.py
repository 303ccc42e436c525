"""internlm2-1.8b [dense] -- GQA. [arXiv:2403.17297]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544 (padded to 92672).
RMSNorm with a scale (``kernels.row_moments.rmsnorm``) and an untied head.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92544,
    norm="rmsnorm",
)

TINY = ModelConfig(
    name="internlm2-tiny",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    norm="rmsnorm",
    dtype="float32",
)
