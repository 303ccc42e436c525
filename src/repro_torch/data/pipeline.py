"""Deterministic, sharded synthetic token stream (numpy only).

A copy of ``ShardInfo`` and ``SyntheticLM`` of ``repro/data/pipeline.py``:
every batch is drawn from ``SeedSequence([seed, step, shard])``, so any host
can rebuild any batch without coordination, and this stream and the
reference's give identical tokens for the same (seed, step, shard).

Batches are ``{"tokens": (local_batch, seq + 1) int32}``; the extra token
supplies the shifted labels.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class ShardInfo:
    shard: int = 0      # this host's data shard index
    n_shards: int = 1   # total data-parallel hosts


class SyntheticLM:
    """Seeded synthetic token stream (zipfian unigram): realistic CE losses
    without a dataset."""

    def __init__(self, vocab: int, seq: int, local_batch: int,
                 shard: ShardInfo | None = None, seed: int = 0,
                 n_codebooks: int = 0):
        self.vocab, self.seq, self.local_batch = vocab, seq, local_batch
        self.shard = shard or ShardInfo()
        self.seed = seed
        self.n_codebooks = n_codebooks
        self.step = 0

    def seek(self, step: int) -> None:
        self.step = step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state(self, st: dict) -> None:
        self.step = int(st["step"])
        if int(st["seed"]) != self.seed:
            raise ValueError("data seed changed across restore")

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard.shard])
        )

    def next(self) -> dict:
        rng = self._rng(self.step)
        shape = (self.local_batch, self.seq + 1)
        if self.n_codebooks:
            shape = shape + (self.n_codebooks,)
        z = rng.zipf(1.3, size=shape)
        tokens = np.minimum(z, self.vocab - 1).astype(np.int32)
        self.step += 1
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()
