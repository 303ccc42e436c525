"""Serving steps: prefill and one-token decode against resident caches.

Port of ``make_prefill_step`` / ``make_decode_step`` of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a plain
closure over the config (the reference jits it).
"""

from __future__ import annotations

import torch

from repro_torch.models import decode_step as model_decode
from repro_torch.models import make_caches, prefill


def make_prefill_step(cfg, s_max: int):
    def prefill_step(params, tokens: torch.Tensor):
        caches = make_caches(cfg, tokens.shape[0], s_max, tokens.device)
        return prefill(params, cfg, tokens, caches)

    return prefill_step


def make_decode_step(cfg, greedy: bool = True):
    def decode_one(params, caches, token: torch.Tensor, pos: int):
        logits, caches = model_decode(params, cfg, token, caches, pos)
        if greedy:
            return torch.argmax(logits, -1).to(torch.int32), caches
        return logits, caches

    return decode_one
