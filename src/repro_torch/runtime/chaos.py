"""Deterministic fault injection for the guarded serving runtime.

A copy of ``repro/runtime/chaos.py``'s ``TransientFault``, ``Preemption``
and ``ChaosMonkey`` (the reference's array-poking ``corrupt`` helpers are
left out: serving injects its faults through ``scale_for`` and
``on_request``). Injection is deterministic and FIRE-ONCE: each configured
(kind, id) fires at most once, so a retry of the same step runs clean --
exactly the semantics of a real transient.
"""

from __future__ import annotations

from typing import Sequence


class TransientFault(RuntimeError):
    """An injected (or real) recoverable step failure: state is intact,
    retrying the step is the correct response."""


class Preemption(TransientFault):
    """A slot/step preemption (duty-cycled capacity, a descheduled core):
    retry like any transient, but do NOT charge the backend's circuit
    breaker -- the kernel did nothing wrong."""


class ChaosMonkey:
    """Deterministic per-request fault injector for the serving runtime.

    nan_steps / inf_steps: request ids whose logits ``scale_for`` drives to
      NaN / Inf once.
    fail_steps: request ids whose step ``on_request`` fails once with
      ``TransientFault`` (charged to the backend's circuit breaker).
    preempt_steps: request ids whose step ``on_request`` preempts once
      (``Preemption``: retried free).

    Every configured (kind, id) fires AT MOST ONCE (``fired``), so retries
    run clean. ``calls`` counts every ``on_request``.
    """

    def __init__(
        self,
        *,
        nan_steps: Sequence[int] = (),
        inf_steps: Sequence[int] = (),
        fail_steps: Sequence[int] = (),
        preempt_steps: Sequence[int] = (),
    ):
        self.nan_steps = frozenset(int(s) for s in nan_steps)
        self.inf_steps = frozenset(int(s) for s in inf_steps)
        self.fail_steps = frozenset(int(s) for s in fail_steps)
        self.preempt_steps = frozenset(int(s) for s in preempt_steps)
        self.fired: set = set()
        self.calls = 0

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        n_steps: int,
        nan_rate: float = 0.0,
        inf_rate: float = 0.0,
        fail_rate: float = 0.0,
        preempt_rate: float = 0.0,
    ) -> "ChaosMonkey":
        """Deterministic random schedule: the same (seed, n_steps, rates)
        yields the same injector on every host and every rerun -- chaos
        that reproduces, and the same schedule as the reference's for the
        same arguments. Id 0 is never selected. The schedule reads "request
        3 decodes a NaN logit once, request 7's launch faults once"."""
        import random

        rng = random.Random(int(seed))
        nan_steps, inf_steps, fail_steps, preempt_steps = [], [], [], []
        for step in range(1, int(n_steps)):
            r = rng.random()
            if r < nan_rate:
                nan_steps.append(step)
            elif r < nan_rate + inf_rate:
                inf_steps.append(step)
            elif r < nan_rate + inf_rate + fail_rate:
                fail_steps.append(step)
            elif r < nan_rate + inf_rate + fail_rate + preempt_rate:
                preempt_steps.append(step)
        return cls(
            nan_steps=nan_steps, inf_steps=inf_steps, fail_steps=fail_steps,
            preempt_steps=preempt_steps,
        )

    def _fire(self, kind: str, step: int) -> bool:
        key = (kind, int(step))
        if key in self.fired:
            return False
        self.fired.add(key)
        return True

    # -- per-request serving hooks (same schedule, keyed by request id) --

    def scale_for(self, request_id: int) -> float:
        """Chaos multiplier for one request's decode step: NaN / Inf iff
        ``request_id`` is a configured (unfired) nan/inf id, else 1.0.
        The serving engine multiplies the slot's logits by it -- x1.0 is
        bitwise identity, so a clean request's tokens are untouched and a
        poisoned slot's retry (fire-once) reproduces the clean run."""
        rid = int(request_id)
        if rid in self.nan_steps and self._fire("nan", rid):
            return float("nan")
        if rid in self.inf_steps and self._fire("inf", rid):
            return float("inf")
        return 1.0

    def on_request(self, request_id: int) -> None:
        """Call once per decode attempt per active request: raises
        ``Preemption`` on a configured (unfired) preempt id (retry, no
        breaker charge) and ``TransientFault`` on a fail id (retry AND
        charge the backend's breaker)."""
        rid = int(request_id)
        self.calls += 1
        if rid in self.preempt_steps and self._fire("preempt", rid):
            raise Preemption(f"injected preemption for request {rid}")
        if rid in self.fail_steps and self._fire("fail", rid):
            raise TransientFault(
                f"injected transient kernel fault for request {rid}"
            )
