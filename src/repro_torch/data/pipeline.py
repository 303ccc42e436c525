"""Deterministic, sharded, resumable token sources (numpy only), their
background prefetch, and the packing offsets of ragged sequences.

A copy of ``ShardInfo``, ``SyntheticLM``, ``MemmapTokens``, ``Prefetcher``
and ``packing_offsets`` of ``repro/data/pipeline.py``:

  * SyntheticLM  -- every batch drawn from ``SeedSequence([seed, step,
    shard])``, so any host can rebuild any batch without coordination;
  * MemmapTokens -- a packed uint32 token file (``np.memmap``), windows of
    seq + 1 tokens in a seeded permuted order per epoch, strided across
    shards.

Both give the reference's tokens bit for bit for the same (file, seed,
step, shard). Batches are ``{"tokens": (local_batch, seq + 1) int32}``; the
extra token supplies the shifted labels. State is ``{step, seed}``, and
``seek(step)`` is O(1): a restarted or rolled-back run jumps, it does not
replay the stream.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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


class MemmapTokens:
    """Packed-token binary reader: windows of (seq + 1) tokens in a seeded
    permuted order, strided across shards. An epoch boundary reshuffles
    with an epoch-dependent seed."""

    def __init__(self, path: str, seq: int, local_batch: int,
                 shard: ShardInfo | None = None, seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.seq, self.local_batch = seq, local_batch
        self.shard = shard or ShardInfo()
        self.seed = seed
        self.step = 0
        self.n_windows = len(self.tokens) // (seq + 1)
        if self.n_windows < local_batch * (shard.n_shards if shard else 1):
            raise ValueError("dataset smaller than one global batch")

    def seek(self, step: int) -> None:
        self.step = step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state(self, st: dict) -> None:
        self.step = int(st["step"])

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(self.n_windows)

    def next(self) -> dict:
        gb = self.local_batch * self.shard.n_shards
        steps_per_epoch = self.n_windows // gb
        epoch, within = divmod(self.step, steps_per_epoch)
        perm = self._perm(epoch)
        base = within * gb + self.shard.shard * self.local_batch
        idx = perm[base : base + self.local_batch]
        w = self.seq + 1
        out = np.stack([self.tokens[i * w : (i + 1) * w] for i in idx])
        self.step += 1
        return {"tokens": out.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()


class Prefetcher:
    """Double-buffered background prefetch (a thread) that hides the host's
    batch preparation behind device steps. Batches come out in the
    source's order; ``close()`` stops the thread."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                batch = source.next()
                while not self._stop.is_set():  # never drop a drawn batch
                    try:
                        self.q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self) -> dict:
        return self.q.get()

    def close(self) -> None:
        self._stop.set()


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
