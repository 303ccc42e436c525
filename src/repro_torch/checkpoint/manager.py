"""Atomic, asynchronous, verified checkpoints of the port's state trees.

A copy of ``repro/checkpoint/manager.py`` for trees of torch tensors, with
the reference's on-disk layout (one directory per step):

  <dir>/step_00000420/
    manifest.json       -- step, per-leaf shape / dtype / CRC32, the
                           data-pipeline state (``extra``), wall time
    shard_00000.npz     -- this host's leaves, one npz entry each
    _COMMITTED          -- written last; a checkpoint without it is ignored

  * atomicity -- a save is written into ``step_X.tmp-<nonce>/`` and moved
    into place by ``os.replace``; a preempted writer never corrupts the
    newest good checkpoint.
  * async     -- ``save()`` copies every leaf into host memory before it
    returns (a fresh copy also for CPU tensors, which the caller keeps
    updating in place), then hashes and writes on a background thread.
  * keep-N    -- bounded disk; ``latest()`` scans for the newest commit.
  * integrity -- each leaf's CRC32 of its raw bytes is in the manifest and
    verified at restore: a flipped bit or a truncated shard raises
    ``CheckpointCorruptionError``; ``quarantine()`` moves a bad step out of
    the committed namespace and ``restore_latest_valid()`` falls back to
    the newest commit that still verifies.

Trees are nested dicts, lists and tuples of tensors (or numpy arrays and
scalars) and dataclasses of them (``optim.AdamWState``). Each leaf is keyed
by its path in the reference's key-string style: ``[0]['embed']['table']``,
``[1].m[3]``; dict keys in sorted order. bf16 leaves are written as their
uint16 bit patterns with ``"bfloat16"`` as the manifest's dtype (numpy has
no bf16), so a leaf's CRC is taken over the same bytes as the reference's.
There is no ``shardings=`` (a replicated state; the elastic restore of a
sharded state is not ported).

``records`` lists each save and restore with its bytes and seconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import time
import uuid
import zlib

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed integrity verification (CRC mismatch,
    unreadable shard archive, or a leaf missing against the manifest). The
    step number and offending path/leaf are in the message; the correct
    response is ``quarantine()`` and a fall back to an older commit."""


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a state tree, in the reference's key-string
    style and flatten order (dict keys sorted)."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return {prefix: tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_flatten(sub, f"{prefix}[{i}]"))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    raise TypeError(f"checkpoint leaves must be tensors or arrays; got {type(tree).__name__} "
                    f"at {prefix or 'the root'}")


def _rebuild(tree, values: dict, prefix: str = ""):
    """A tree shaped like ``tree`` with each leaf replaced by ``values[path]``."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return values[prefix]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: _rebuild(getattr(tree, f.name), values, f"{prefix}.{f.name}")
        for f in dataclasses.fields(tree)})


def _host_array(leaf) -> np.ndarray:
    """A host copy of one leaf, as the array written to disk: bf16 as its
    uint16 bit patterns."""
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.array(leaf, copy=True)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _to_like(arr: np.ndarray, dtype: str | None, like):
    """The loaded array as a leaf like ``like``: its type, dtype and device."""
    arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, (np.ndarray, np.generic)):
        if like.dtype.name == "bfloat16" or dtype == "bfloat16":
            raise TypeError("bf16 leaves restore into tensors, not numpy arrays")
        return t.numpy().astype(like.dtype)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, host_id: int = 0, n_hosts: int = 1):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        self.records: list = []

    # ------------------------------ save --------------------------------

    def save(self, step: int, tree, extra: dict | None = None, blocking: bool = False) -> None:
        """Snapshot now, flush in the background (one outstanding save at a
        time)."""
        self.wait()
        t0 = time.perf_counter()
        flat = _flatten(tree)
        dtypes = {k: ("bfloat16" if getattr(v, "dtype", None) == torch.bfloat16 else None)
                  for k, v in flat.items()}
        host_np = {k: _host_array(v) for k, v in flat.items()}
        record = {"op": "save", "step": int(step),
                  "bytes": sum(a.nbytes for a in host_np.values()),
                  "snapshot_s": time.perf_counter() - t0}
        self.records.append(record)

        def flush():
            try:
                write()
            except Exception as e:  # re-raised by wait(), in the caller's thread
                self._error = e

        def write():
            t1 = time.perf_counter()
            meta = {
                "step": int(step),
                "time": time.time(),
                "n_hosts": self.n_hosts,
                "leaves": {
                    k: {"shape": list(v.shape), "dtype": dtypes[k] or str(v.dtype),
                        # CRC of the leaf's raw bytes: one pass at save time,
                        # catches bit rot and torn writes at restore
                        "crc32": _crc(v)}
                    for k, v in host_np.items()
                },
                "extra": extra or {},
            }
            tmp = self.dir / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
            tmp.mkdir(parents=True)
            np.savez(tmp / f"shard_{self.host_id:05d}.npz", **host_np)
            if self.host_id == 0:
                (tmp / "manifest.json").write_text(json.dumps(meta))
                (tmp / "_COMMITTED").write_text("ok")
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
            record["flush_s"] = time.perf_counter() - t1

        t = threading.Thread(target=flush, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Block until the outstanding save is on disk; a save whose flush
        failed raises its error here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self._committed_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------- restore ------------------------------

    def _committed_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(tuple("0123456789")) and (p / "_COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest(self) -> int | None:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, step: int, like_tree, verify: bool = True):
        """Load into the structure of ``like_tree``: each leaf with the
        dtype of, and on the device of, its ``like_tree`` leaf.

        ``verify=True`` (default) checks every loaded leaf's CRC32 against
        the manifest written at save time: a flipped bit, a truncated npz,
        or a leaf the manifest promised but the shards lack raises
        ``CheckpointCorruptionError`` BEFORE any state reaches the model.
        Manifests without a ``crc32`` key verify vacuously."""
        t0 = time.perf_counter()
        path = self.dir / f"step_{step:08d}"
        if not (path / "_COMMITTED").exists():
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        try:
            man_leaves = json.loads((path / "manifest.json").read_text()).get("leaves", {})
        except (OSError, json.JSONDecodeError) as e:
            if verify:
                raise CheckpointCorruptionError(
                    f"step {step}: unreadable manifest at {path}: {e}") from e
            man_leaves = {}
        crcs = {k: v["crc32"] for k, v in man_leaves.items() if "crc32" in v} if verify else {}
        data = {}
        for shard_file in sorted(path.glob("shard_*.npz")):
            try:
                with np.load(shard_file) as z:
                    for k in z.files:
                        data[k] = z[k]
            except Exception as e:  # a truncated or garbled zip: BadZipFile,
                raise CheckpointCorruptionError(  # OSError, ValueError, ...
                    f"step {step}: unreadable shard {shard_file.name}: {e}") from e
        for k, want in crcs.items():
            if k not in data:
                raise CheckpointCorruptionError(
                    f"step {step}: manifest lists leaf {k} but no shard provides it")
            got = _crc(data[k])
            if got != want:
                raise CheckpointCorruptionError(
                    f"step {step}: leaf {k} CRC mismatch "
                    f"(manifest {want:#010x}, on disk {got:#010x})")
        values = {}
        for k, like in _flatten(like_tree).items():
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k}")
            arr = data[k]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{k}: shape {arr.shape} != {tuple(like.shape)}")
            values[k] = _to_like(arr, man_leaves.get(k, {}).get("dtype"), like)
        tree = _rebuild(like_tree, values)
        self.records.append({"op": "restore", "step": int(step), "verified": bool(crcs),
                             "bytes": sum(a.nbytes for a in data.values()),
                             "seconds": time.perf_counter() - t0})
        return tree

    def quarantine(self, step: int) -> pathlib.Path:
        """Move a corrupt checkpoint out of the committed namespace (rename
        to ``quarantine_step_XXXXXXXX``, which the ``step_*`` scan never
        matches) instead of deleting it: the bytes stay on disk for
        forensics, but ``latest()``/``restore_latest_valid()`` never offer
        it again."""
        src = self.dir / f"step_{step:08d}"
        dst = self.dir / f"quarantine_step_{step:08d}"
        if dst.exists():
            shutil.rmtree(dst)
        os.replace(src, dst)
        return dst

    def restore_latest_valid(self, like_tree):
        """The newest committed checkpoint that passes CRC verification.

        Walks commits newest-first; each one that fails verification is
        quarantined and the walk falls back to the previous commit.
        Returns ``(tree, step)``; raises ``FileNotFoundError`` if no
        committed checkpoint survives."""
        while True:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint in {self.dir} passed integrity verification")
            try:
                return self.restore(step, like_tree), step
            except CheckpointCorruptionError:
                self.quarantine(step)

    def manifest(self, step: int) -> dict:
        return json.loads((self.dir / f"step_{step:08d}" / "manifest.json").read_text())
