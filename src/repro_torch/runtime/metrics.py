"""Guard observability: counters for the skip/retry/rollback machinery.

A copy of ``repro/runtime/metrics.py`` (plain Python, no torch needed).

A guarded run that silently skips 30% of its steps is a broken run that
LOOKS healthy; these counters make the guard's behavior visible. The
supervisor records one entry per step, the launcher logs the snapshot at
every checkpoint commit, and ``write()`` exports an atomic JSON status
file that an external watchdog (or the next incarnation after a restart)
can poll without touching the training process.

Callers pass already-materialized floats/ints.
"""

from __future__ import annotations

import json
import os
import tempfile


class GuardMetrics:
    """Monotone counters + last-seen gauges for the guarded loop."""

    def __init__(self):
        self.steps_total = 0
        self.steps_skipped = 0
        self.retries = 0
        self.rollbacks = 0
        self.commits = 0
        self.last_census_total = 0.0
        self.last_step = -1
        self.divergence_checks_passed = 0

    def record_step(self, step: int, *, skipped: bool,
                    census_total: float = 0.0) -> None:
        self.steps_total += 1
        self.last_step = int(step)
        self.last_census_total = float(census_total)
        if skipped:
            self.steps_skipped += 1

    def record_retry(self, n: int = 1) -> None:
        self.retries += int(n)

    def record_rollback(self) -> None:
        self.rollbacks += 1

    def record_commit(self) -> None:
        self.commits += 1

    def record_agreement(self, checks_passed: int) -> None:
        """Absolute counter from ``AgreementChecker.checks_passed``."""
        self.divergence_checks_passed = int(checks_passed)

    def snapshot(self) -> dict:
        return {
            "steps_total": self.steps_total,
            "steps_skipped": self.steps_skipped,
            "retries": self.retries,
            "rollbacks": self.rollbacks,
            "commits": self.commits,
            "last_census_total": self.last_census_total,
            "last_step": self.last_step,
            "divergence_checks_passed": self.divergence_checks_passed,
        }

    def write(self, path) -> None:
        """Atomic JSON export: write-to-temp + ``os.replace`` so a poller
        never observes a torn file, even if the trainer dies mid-write."""
        path = os.fspath(path)
        d = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".guard_metrics_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (no numpy: this
    module stays import-light for watchdog processes)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


class ServeMetrics(GuardMetrics):
    """The serving runtime's SLO counters, layered on the guard counters.

    Admission (admitted/shed_queue_full/shed_infeasible), deadline misses,
    per-slot quarantines, breaker trips + live per-backend breaker states,
    completed requests/tokens, and a bounded reservoir of per-token decode
    latencies summarized as p50/p99 in the snapshot. Everything exports
    through the same atomic-JSON ``write()`` (``--status-path``) the
    training supervisor uses, so one watchdog polls both shapes."""

    def __init__(self, latency_window: int = 4096):
        super().__init__()
        self.admitted = 0
        self.shed_queue_full = 0
        self.shed_infeasible = 0
        self.deadline_missed = 0
        self.quarantined = 0
        self.rejected_poisoned = 0
        self.breaker_trips = 0
        self.completed = 0
        self.tokens_out = 0
        self.breaker_states: dict = {}
        self._latency_window = int(latency_window)
        self._latencies: list = []

    def record_admit(self) -> None:
        self.admitted += 1

    def record_shed(self, *, infeasible: bool = False) -> None:
        if infeasible:
            self.shed_infeasible += 1
        else:
            self.shed_queue_full += 1

    def record_deadline_miss(self) -> None:
        self.deadline_missed += 1

    def record_quarantine(self, n: int = 1) -> None:
        self.quarantined += int(n)

    def record_poisoned(self) -> None:
        self.rejected_poisoned += 1

    def record_breaker_trip(self) -> None:
        self.breaker_trips += 1

    def record_breaker_states(self, states: dict) -> None:
        """Live gauge: {backend name: "closed"|"open"|"half_open"}."""
        self.breaker_states = dict(states)

    def record_completed(self, n_tokens: int) -> None:
        self.completed += 1
        self.tokens_out += int(n_tokens)

    def record_token_latency(self, seconds: float) -> None:
        """One decode step's wall time (one token per active slot). The
        reservoir keeps the newest ``latency_window`` samples -- a long-
        running server's tail stays current, not lifetime-averaged."""
        self._latencies.append(float(seconds))
        if len(self._latencies) > self._latency_window:
            del self._latencies[: len(self._latencies) - self._latency_window]

    def snapshot(self) -> dict:
        lat = sorted(self._latencies)
        snap = super().snapshot()
        snap.update(
            {
                "admitted": self.admitted,
                "shed_queue_full": self.shed_queue_full,
                "shed_infeasible": self.shed_infeasible,
                "deadline_missed": self.deadline_missed,
                "quarantined": self.quarantined,
                "rejected_poisoned": self.rejected_poisoned,
                "breaker_trips": self.breaker_trips,
                "breaker_states": self.breaker_states,
                "completed": self.completed,
                "tokens_out": self.tokens_out,
                "token_latency_p50_s": _percentile(lat, 0.50),
                "token_latency_p99_s": _percentile(lat, 0.99),
                "token_latency_samples": len(lat),
            }
        )
        return snap
