"""olmo-1b [dense] -- non-parametric LayerNorm. [arXiv:2402.00838]

16L d_model=2048 16H (GQA kv=16 -> MHA) d_ff=8192 vocab=50304.
OLMo's LN has no scale/bias -- the pure-statistics case of the paper's
MMA reduction (``kernels.row_moments.layernorm_np``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="olmo-tiny",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    norm="layernorm_np",
    tie_embeddings=True,
    dtype="float32",
)
