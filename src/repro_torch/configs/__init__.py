"""Architecture registry: ``--arch <id>`` resolution for the launchers.

ARCHS maps arch id -> full ModelConfig (the published dims); TINY_ARCHS
maps arch id -> a reduced same-family config small enough for the CPU;
SHAPES maps the four assigned shape cells by name. The dense archs
(olmo-1b, internlm2-1.8b, deepseek-7b), the MoE archs
(granite-moe-1b-a400m, dbrx-132b), MLA (minicpm3-4b), the SSM
(mamba2-780m), the RG-LRU hybrid with local attention (recurrentgemma-9b),
vision cross-attention (llama-3.2-vision-11b) and the audio family's four
codebook streams (musicgen-medium): every arch of the reference.
"""

from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    deepseek_7b,
    granite_moe_1b,
    internlm2_1_8b,
    llama32_vision_11b,
    mamba2_780m,
    minicpm3_4b,
    musicgen_medium,
    olmo_1b,
    recurrentgemma_9b,
)
from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    ShapeConfig,
    TrainConfig,
    shape_applicable,
)

_MODULES = (olmo_1b, deepseek_7b, internlm2_1_8b, granite_moe_1b, dbrx_132b, minicpm3_4b,
            mamba2_780m, recurrentgemma_9b, llama32_vision_11b, musicgen_medium)

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
TINY_ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.TINY for m in _MODULES}
SHAPES: dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def get_arch(name: str, tiny: bool = False) -> ModelConfig:
    table = TINY_ARCHS if tiny else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]
