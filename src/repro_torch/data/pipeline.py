"""Deterministic, sharded synthetic token stream (numpy only), and the
packing offsets of ragged sequences.

A copy of ``ShardInfo``, ``SyntheticLM`` and ``packing_offsets`` of
``repro/data/pipeline.py``:
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


def packing_offsets(lengths, backend=None):
    """(N,) sequence lengths -> (N + 1,) int32 offsets [0, l0, l0 + l1, ...]
    of the sequences packed into one flat buffer, by the engine's scan
    (``repro_torch.scan``), on the lengths' device. ``backend=None`` takes
    the auto route, which keeps integer lengths on the exact integer
    cumsum; an explicit kernel or MMA backend scans in f32, integer-exact
    only while the total is below 2**24."""
    import torch

    from repro_torch.reduce.scan import scan

    lengths = torch.as_tensor(lengths).to(torch.int32)
    if lengths.ndim != 1:
        raise ValueError("packing_offsets expects a 1-D length vector")
    incl = scan(lengths, backend=backend).to(torch.int32)
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=incl.device), incl])
