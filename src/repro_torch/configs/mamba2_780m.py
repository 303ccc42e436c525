"""mamba2-780m [ssm] -- SSD (state-space duality). [arXiv:2405.21060]

48L d_model=1536, attention-free (d_ff=0: the Mamba block is the whole
layer), vocab=50280 (padded to 50432), d_state=128, expand 2 (d_inner
3072, 48 heads of 64), 1 group, conv width 4, chunk 256, tied embeddings:
0.78 B parameters. Sub-quadratic: its decode state is O(1) a layer (the
conv window and a 48 x 64 x 128 f32 state a slot).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, n_groups=1, conv_width=4, chunk=256),
    tie_embeddings=True,  # mamba2 reference ties embeddings
)

TINY = ModelConfig(
    name="mamba2-tiny",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=256,
    block_pattern=("ssm",),
    norm="rmsnorm",
    ssm=SSMConfig(d_state=16, expand=2, headdim=16, n_groups=1, conv_width=4, chunk=16),
    tie_embeddings=True,
    dtype="float32",
)
