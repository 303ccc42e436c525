"""Cross-rank agreement checking for the guarded training loop.

Port of ``repro/runtime/agreement.py`` (its own copy: the port imports
nothing of the reference). The data-mesh guarded step
(``launch.steps.make_mesh_guarded_train_step``) is DESIGNED so that every
rank computes bit-identical statistics -- the fixed-order combine makes the
skip flag, the census and the clip coefficient the same on every rank by
construction. This module checks it: each rank fingerprints its view of
the step (the census counts, the guard decision, the statistic's bits) and
an ``AgreementChecker`` cross-verifies the fingerprints, raising a
``DivergenceError`` that names the FIRST disagreeing host and the step the
moment any rank departs from the others.

Plain Python with numpy and torch at the edges: ``fingerprint`` hashes
torch tensors (on any device; bf16 by its bits) and numpy arrays alike, a
tensor and an array of the same shape, dtype and bits hashing the same.

The ``Transport`` ABC closes the loop to REAL processes: ``publish`` one
host's fingerprint, ``fetch`` the roster seen so far, and ``exchange``
drives a full record-poll-check round against any implementation.
``FileTransport`` is the minimal loopback -- one atomically renamed file
per (step, host) under a shared directory -- enough for ranks on one
machine; a key-value store implements the same two methods for a fleet.
"""

from __future__ import annotations

import abc
import hashlib
import os
import tempfile
import time
from typing import Mapping


class DivergenceError(RuntimeError):
    """A replica's fingerprint disagrees with the fleet reference.

    Attributes name the first (lowest-id) disagreeing host and the step,
    plus both fingerprints, so the launcher can fence exactly the replica
    that went wrong instead of restarting the world blind.
    """

    def __init__(self, step: int, host: int, expected: str, got: str):
        self.step = int(step)
        self.host = int(host)
        self.expected = expected
        self.got = got
        super().__init__(
            f"replica divergence at step {step}: host {host} reports "
            f"fingerprint {got[:16]}.. but the fleet reference (host 0) "
            f"is {expected[:16]}.."
        )


def fingerprint(*parts) -> str:
    """sha256 hex digest over a heterogeneous tuple of step artifacts.

    Arrays hash their raw bytes PLUS shape/dtype tags (so a transposed or
    recast array cannot collide); floats hash their IEEE bits via numpy
    (so two hosts disagreeing only in the last ulp still diverge -- the
    whole point of the bitwise-deterministic combine); str/bytes/int hash
    their obvious encodings. Nested tuples/lists/dicts recurse with
    delimiters. Deliberately NOT Python ``hash()``: must be stable across
    processes and hosts.
    """
    import numpy as np
    import torch

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, (tuple, list)):
            h.update(b"(")
            for item in x:
                feed(item)
                h.update(b",")
            h.update(b")")
        elif isinstance(x, Mapping):
            h.update(b"{")
            for k in sorted(x):
                feed(str(k))
                h.update(b":")
                feed(x[k])
                h.update(b",")
            h.update(b"}")
        elif isinstance(x, bytes):
            h.update(b"b" + x)
        elif isinstance(x, str):
            h.update(b"s" + x.encode())
        elif isinstance(x, bool):
            h.update(b"B1" if x else b"B0")
        elif isinstance(x, int):
            h.update(b"i" + str(x).encode())
        elif isinstance(x, float):
            h.update(b"f" + np.float64(x).tobytes())
        elif x is None:
            h.update(b"N")
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            dtype = str(t.dtype).replace("torch.", "")
            if t.is_floating_point():  # by its bits: bf16 has no numpy dtype
                t = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                            8: torch.int64}[t.element_size()])
            h.update(b"a" + str(tuple(t.shape)).encode() + dtype.encode())
            h.update(t.numpy().tobytes())
        else:  # ndarray / numpy scalar / anything exposing the array protocol
            a = np.asarray(x)
            h.update(b"a" + str(a.shape).encode() + str(a.dtype).encode())
            h.update(np.ascontiguousarray(a).tobytes())

    for part in parts:
        feed(part)
        h.update(b";")
    return h.hexdigest()


def step_fingerprint(step: int, census, skipped, statistic) -> str:
    """The canonical guard fingerprint: step number + census counts +
    skip decision + the combined statistic's bits. Hosts running the
    deterministic mesh path MUST produce identical strings."""
    return fingerprint(int(step), census, skipped, statistic)


class AgreementChecker:
    """Cross-verify per-host fingerprints against the host-0 reference.

    Feed it with ``record(step, host, fp)`` in any order (the transport --
    allgather, KV store, test dict -- is the caller's business). Once the
    reference (host 0) for a step is known, every other host's record is
    checked immediately; ``check(step)`` additionally verifies the roster
    is complete. The first disagreement raises ``DivergenceError`` naming
    the lowest disagreeing host id. ``checks_passed`` counts fully-agreed
    steps for the metrics exporter.
    """

    def __init__(self, n_hosts: int):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1; got {n_hosts}")
        self.n_hosts = int(n_hosts)
        self._steps: dict[int, dict[int, str]] = {}
        self.checks_passed = 0

    def record(self, step: int, host: int, fp: str) -> None:
        step, host = int(step), int(host)
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} out of range [0, {self.n_hosts})")
        seen = self._steps.setdefault(step, {})
        seen[host] = fp
        ref = seen.get(0)
        if ref is None:
            return
        for h in sorted(seen):
            if seen[h] != ref:
                raise DivergenceError(step, h, ref, seen[h])

    def check(self, step: int) -> bool:
        """Assert the step's roster is complete and unanimous. Returns
        True (and bumps ``checks_passed``) or raises."""
        step = int(step)
        seen = self._steps.get(step, {})
        missing = [h for h in range(self.n_hosts) if h not in seen]
        if missing:
            raise RuntimeError(
                f"agreement check at step {step}: no fingerprint from "
                f"host(s) {missing} (dead or silent -- heartbeat's problem, "
                f"not a divergence)"
            )
        ref = seen[0]
        for h in range(1, self.n_hosts):
            if seen[h] != ref:
                raise DivergenceError(step, h, ref, seen[h])
        self.checks_passed += 1
        del self._steps[step]  # bounded memory across a long run
        return True


class Transport(abc.ABC):
    """Fingerprint exchange between REAL processes (the checker itself is
    transport-agnostic; this is the wire). Implementations must make
    ``publish`` atomic-per-record and ``fetch`` return only complete
    records -- a reader must never observe a torn fingerprint."""

    @abc.abstractmethod
    def publish(self, step: int, host: int, fp: str) -> None:
        """Make (step, host) -> fp visible to every other participant."""

    @abc.abstractmethod
    def fetch(self, step: int) -> dict:
        """All fingerprints published for ``step`` so far: {host: fp}."""


class FileTransport(Transport):
    """Shared-directory loopback transport: one file per (step, host),
    written tmp + ``os.replace`` (the same atomicity discipline as the
    metrics exporter) so concurrent readers in other processes see either
    nothing or the whole fingerprint. Works across real OS processes on
    one node (tests) or any shared filesystem (NFS caveat: rename is
    atomic per POSIX, visibility lag is the poller's timeout problem)."""

    def __init__(self, root):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, step: int, host: int) -> str:
        return os.path.join(self.root, f"step{int(step):012d}.host{int(host)}")

    def publish(self, step: int, host: int, fp: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".fp_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(fp)
            os.replace(tmp, self._path(step, host))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def fetch(self, step: int) -> dict:
        prefix = f"step{int(step):012d}.host"
        out = {}
        for name in os.listdir(self.root):
            if not name.startswith(prefix):
                continue
            try:
                host = int(name[len(prefix):])
            except ValueError:
                continue
            with open(os.path.join(self.root, name)) as f:
                out[host] = f.read()
        return out


def exchange(
    checker: AgreementChecker,
    transport: Transport,
    step: int,
    host: int,
    fp: str,
    *,
    timeout_s: float = 30.0,
    poll_s: float = 0.02,
    clock=time.monotonic,
    sleep=time.sleep,
) -> bool:
    """One full agreement round over a real transport: publish this host's
    fingerprint, poll until the roster for ``step`` is complete (or
    ``timeout_s``), feed every record to the checker, and run the final
    unanimity check. Raises ``DivergenceError`` the moment any fetched
    fingerprint disagrees with the host-0 reference, ``TimeoutError`` if
    the roster never fills (a dead host -- the heartbeat's problem, but
    the caller must not hang forever waiting to learn it). ``clock`` and
    ``sleep`` are injectable for deterministic tests."""
    transport.publish(step, host, fp)
    deadline = clock() + timeout_s
    while True:
        seen = transport.fetch(step)
        if len(seen) >= checker.n_hosts:
            break
        if clock() >= deadline:
            missing = [
                h for h in range(checker.n_hosts) if h not in seen
            ]
            raise TimeoutError(
                f"agreement exchange at step {step}: no fingerprint from "
                f"host(s) {missing} within {timeout_s}s"
            )
        sleep(poll_s)
    for h in sorted(seen):
        checker.record(step, h, seen[h])
    return checker.check(step)
