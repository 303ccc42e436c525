"""Fault-tolerance runtime of the training loop.

A copy of ``repro/runtime/fault_tolerance.py`` (plain Python: no torch is
needed). Pieces, all testable on one host:

  HeartbeatTracker    -- per-host liveness and step timing; marks hosts
                         dead after ``timeout_s`` of silence and flags
                         stragglers whose recent median step time exceeds
                         ``straggler_factor`` x the fleet's.
  PreemptionGuard     -- SIGTERM/SIGINT -> a "checkpoint, then exit" flag;
                         ``uninstall()`` puts the earlier handlers back.
  ElasticPlan         -- given the surviving hosts, the next mesh shape
                         (model degree kept) and the batch re-split.
  TrainSupervisor     -- glue: wraps a step function with heartbeats,
                         preemption checks, periodic checkpoints, automatic
                         resume, and (with a ``StepGuard``) the step-0
                         anchor commit and rollback to the last commit with
                         the data rewound.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


class HeartbeatTracker:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.last_seen = {h: time.monotonic() for h in range(n_hosts)}
        self.step_times: dict[int, list] = {h: [] for h in range(n_hosts)}
        # last guard-metrics snapshot each host attached to a beat: lets
        # the supervisor's liveness channel double as the guard-health
        # channel (a host that is alive but skipping every step shows up
        # here, not in dead_hosts)
        self.last_metrics: dict[int, dict] = {}

    def beat(self, host: int, step_time_s: float | None = None,
             now: float | None = None, metrics: dict | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_seen[host] = now
        if step_time_s is not None:
            t = self.step_times[host]
            t.append(step_time_s)
            if len(t) > 32:
                del t[:-32]
        if metrics is not None:
            self.last_metrics[host] = dict(metrics)

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]

    @staticmethod
    def _median(xs: list) -> float:
        s = sorted(xs)
        n = len(s)
        return 0.5 * (s[(n - 1) // 2] + s[n // 2])

    def stragglers(self) -> list[int]:
        """Hosts whose RECENT-WINDOW median step time exceeds
        ``straggler_factor`` x the fleet median of those medians. Keying
        off each host's window median (the 32-sample ``beat`` buffer)
        instead of its single last step means one slow step -- a GC pause,
        a checkpoint flush -- cannot flag a healthy host; a genuine
        straggler shifts its whole window and still trips the factor."""
        meds = {
            h: self._median(t) for h, t in self.step_times.items() if t
        }
        if len(meds) < max(2, self.n_hosts // 2):
            return []
        fleet = self._median(list(meds.values()))
        return [
            h for h, m in meds.items()
            if m > self.straggler_factor * fleet
        ]

    def healthy(self, now: float | None = None) -> list[int]:
        dead = set(self.dead_hosts(now))
        return [h for h in range(self.n_hosts) if h not in dead]


class PreemptionGuard:
    """SIGTERM -> graceful "checkpoint and exit". Poll `should_stop`."""

    def __init__(self, install: bool = True):
        self._flag = False
        self._previous = {}
        if install:
            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not main thread (tests)

    def uninstall(self) -> None:
        """Put back the handlers this guard replaced."""
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        self._previous = {}

    def _handler(self, signum, frame):
        self._flag = True

    def trigger(self) -> None:  # testing / external schedulers
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Next-incarnation topology after losing hosts.

    Model-parallel degree is preserved (param layouts stay valid, only the
    data axis shrinks), so restore moves each leaf to its new device -- no weight
    resharding math. Batch is re-split over the surviving data degree;
    global batch is kept by raising grad-accumulation microbatches.
    """

    n_hosts: int
    devices_per_host: int
    model_degree: int
    global_batch: int

    def plan(self, survivors: list[int]) -> dict:
        n = len(survivors)
        total = n * self.devices_per_host
        if total % self.model_degree:
            # drop hosts to the largest multiple that preserves model degree
            keep = (total // self.model_degree) * self.model_degree
            n = keep // self.devices_per_host
            survivors = survivors[:n]
            total = n * self.devices_per_host
        data_degree = total // self.model_degree
        if data_degree == 0:
            raise RuntimeError("not enough survivors for one model replica")
        micro = 1
        while (self.global_batch // micro) % data_degree or \
                (self.global_batch // micro) // data_degree > 64:
            micro += 1
            if micro > self.global_batch:
                raise RuntimeError("cannot split batch over survivors")
        return {
            "hosts": survivors,
            "mesh_shape": (data_degree, self.model_degree),
            "microbatches": micro,
            "local_batch": self.global_batch // micro // data_degree,
        }


class TrainSupervisor:
    """Single-host view of the supervision loop (transport pluggable)."""

    def __init__(self, step_fn: Callable, ckpt, data, *, host_id: int = 0,
                 n_hosts: int = 1, ckpt_every: int = 100,
                 guard: PreemptionGuard | None = None,
                 step_guard=None, metrics=None, status_path=None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.data = data
        self.host_id = host_id
        self.tracker = HeartbeatTracker(n_hosts)
        self.guard = guard or PreemptionGuard(install=False)
        self.ckpt_every = ckpt_every
        # Duck-typed chaos.StepGuard: retry(fn, ...)/record(skipped)/
        # should_rollback()/reset(). None = pre-guard behavior exactly.
        self.step_guard = step_guard
        # Duck-typed metrics.GuardMetrics: record_step/record_retry/
        # record_rollback/record_commit/snapshot/write. None = no-op.
        # status_path: atomic JSON status file, rewritten at every commit.
        self.metrics = metrics
        self.status_path = status_path

    def _export_metrics(self) -> None:
        if self.metrics is None:
            return
        self.metrics.record_commit()
        if self.status_path is not None:
            self.metrics.write(self.status_path)

    def resume(self, state):
        """state = (params, opt_state). Returns (state, start_step).

        BARRIER FIRST: ``save()`` snapshots synchronously but FLUSHES on a
        background thread, so a prior incarnation's save can still be
        mid-flush (tmp dir, no ``_COMMITTED``) when the restart scans for
        checkpoints -- ``latest()`` would silently resume one checkpoint
        early and replay data the flushing save already covered. Draining
        the writer makes resume-after-save deterministic: whatever
        ``save()`` was called is either committed and found, or its
        incarnation died pre-commit and the previous commit is genuinely
        the newest state."""
        wait = getattr(self.ckpt, "wait", None)
        if callable(wait):
            wait()
        latest = self.ckpt.latest()
        if latest is None:
            return state, 0
        tree = self.ckpt.restore(latest, state)
        man = self.ckpt.manifest(latest)
        self.data.seek(man["extra"].get("data_step", latest))
        return tree, latest

    def _rollback(self, state):
        """Restore the last COMMITTED checkpoint and rewind the data
        pipeline to its recorded step. Returns (state, step)."""
        self.ckpt.wait()
        latest = self.ckpt.latest()
        if latest is None:
            raise RuntimeError(
                "rollback requested but no committed checkpoint exists; "
                "the supervisor saves a step-0 anchor when a step_guard is "
                "installed, so this means the checkpoint dir was removed "
                "out from under the run"
            )
        tree = self.ckpt.restore(latest, state)
        man = self.ckpt.manifest(latest)
        self.data.seek(man["extra"].get("data_step", latest))
        return tree, latest

    def run(self, state, n_steps: int):
        state, start = self.resume(state)
        step = start
        if self.step_guard is not None and self.ckpt.latest() is None:
            # anchor commit: rollback must always have a target, even if
            # the guard trips before the first periodic checkpoint
            self.ckpt.save(
                0, state, extra={"data_step": self.data.state()["step"]}
            )
        while step < n_steps:
            t0 = time.monotonic()
            batch = self.data.next()
            if self.step_guard is not None:
                before = self.step_guard.transient_failures
                state, metrics = self.step_guard.retry(
                    self.step_fn, state, batch
                )
                if self.metrics is not None:
                    self.metrics.record_retry(
                        self.step_guard.transient_failures - before
                    )
            else:
                state, metrics = self.step_fn(state, batch)
            step += 1
            skipped = False
            census_total = 0.0
            if self.step_guard is not None:
                if isinstance(metrics, dict):
                    skipped = float(metrics.get("skipped", 0.0)) > 0.0
                    census_total = float(metrics.get("nonfinite", 0.0))
                self.step_guard.record(skipped)
            if self.metrics is not None:
                self.metrics.record_step(
                    step, skipped=skipped, census_total=census_total
                )
            self.tracker.beat(
                self.host_id, time.monotonic() - t0,
                metrics=(
                    self.metrics.snapshot()
                    if self.metrics is not None else None
                ),
            )
            if self.step_guard is not None and \
                    self.step_guard.should_rollback():
                state, step = self._rollback(state)
                self.step_guard.reset()
                self.step_guard.rollbacks = (
                    getattr(self.step_guard, "rollbacks", 0) + 1
                )
                if self.metrics is not None:
                    self.metrics.record_rollback()
                    if self.status_path is not None:
                        self.metrics.write(self.status_path)
                continue
            # never COMMIT mid-skip-streak: a periodic save after a skipped
            # step would record a data position past batches whose update
            # never applied, silently shrinking the rollback window
            if (step % self.ckpt_every == 0 and not skipped) \
                    or self.guard.should_stop:
                self.ckpt.save(
                    step, state, extra={"data_step": self.data.state()["step"]}
                )
                self._export_metrics()
            if self.guard.should_stop:
                self.ckpt.wait()
                return state, step, "preempted"
        self.ckpt.wait()
        return state, step, "done"
