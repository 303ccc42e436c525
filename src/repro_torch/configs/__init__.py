"""Architecture registry: ``--arch <id>`` resolution for the launchers.

ARCHS maps arch id -> full ModelConfig (the published dims); TINY_ARCHS
maps arch id -> a reduced same-family config small enough for the CPU.
Only olmo-1b is ported so far.
"""

from __future__ import annotations

from repro_torch.configs import olmo_1b
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401

_MODULES = (olmo_1b,)

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
TINY_ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.TINY for m in _MODULES}


def get_arch(name: str, tiny: bool = False) -> ModelConfig:
    table = TINY_ARCHS if tiny else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]
