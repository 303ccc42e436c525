"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427]

38L d_model=4096, 16 heads on 1 kv head (MQA) of 256, d_ff=12288,
vocab=256000 (untied head), window=2048, lru_width=4096, logits soft-capped
at 30. Pattern (rec, rec, local_attn): 12 full units and a 2-layer tail
(rec, rec). Sub-quadratic (a ring KV cache of at most ``window`` slots and
O(1) recurrent state a layer): long_500k runs. 9.57 B parameters: it
serves on one card and trains there only cut in depth
(``launch.train.check_fits_card``).
"""

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local_attn"),
    window=2048,
    norm="rmsnorm",
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    logits_softcap=30.0,
)

TINY = ModelConfig(
    name="recurrentgemma-tiny",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rec", "rec", "local_attn"),
    window=16,
    norm="rmsnorm",
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
    logits_softcap=30.0,
    dtype="float32",
)
