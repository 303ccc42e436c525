"""Deterministic fault injection, and the retry/rollback policy of the
guarded training loop.

A copy of ``repro/runtime/chaos.py`` (``TransientFault``, ``Preemption``,
``ChaosMonkey``, ``StepGuard``) for torch tensors. Training dies in three
characteristic ways, each with its own response:

  non-finite gradients  -- detected by the clip statistic's in-launch
                           census, answered by ``optim.guarded_apply_updates``'s
                           bitwise skip; ``ChaosMonkey.corrupt`` injects the
                           NaN/Inf.
  transient exceptions  -- the step raises but the state is intact:
                           bounded-backoff retry (``StepGuard.retry``);
                           ``ChaosMonkey.on_step`` raises the fault.
  persistent badness    -- K consecutive skips: rollback to the last
                           COMMITTED checkpoint with the data rewound
                           (``StepGuard.should_rollback`` and the training
                           loop or ``runtime.TrainSupervisor``).

Serving takes the same schedule through ``scale_for`` and ``on_request``,
keyed by request id. Injection is deterministic and FIRE-ONCE: each
configured (kind, step) fires at most once, so a retry or a post-rollback
replay of the same step runs clean -- exactly the semantics of a real
transient.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


class TransientFault(RuntimeError):
    """An injected (or real) recoverable step failure: state is intact,
    retrying the step is the correct response."""


class Preemption(TransientFault):
    """A slot/step preemption (duty-cycled capacity, a descheduled core):
    retry like any transient, but do NOT charge the backend's circuit
    breaker -- the kernel did nothing wrong."""


class ChaosMonkey:
    """Deterministic fault injector for the guarded training loop and the
    serving runtime.

    Training (step numbers):
      nan_steps / inf_steps: steps whose gradients ``corrupt`` poisons (one
        element: flat element 0 of leaf ``leaf``) with NaN / Inf;
      fail_steps: steps where ``on_step`` raises ``TransientFault``;
      preempt_at: the step where ``on_step`` trips a ``PreemptionGuard``;
      host: this injector's host id; ``corrupt_shard`` poisons only that
        host's shard of a global array.
    Serving (request ids): ``scale_for`` drives a nan/inf id's logits to
      NaN / Inf once; ``on_request`` raises ``Preemption`` on a preempt id
      (retried free) and ``TransientFault`` on a fail id (charged to the
      backend's circuit breaker).

    Every configured (kind, step) fires AT MOST ONCE (``fired``), so
    retries and replays run clean. ``calls`` counts every ``on_step`` and
    ``on_request``.
    """

    def __init__(
        self,
        *,
        nan_steps: Sequence[int] = (),
        inf_steps: Sequence[int] = (),
        fail_steps: Sequence[int] = (),
        preempt_steps: Sequence[int] = (),
        preempt_at: int | None = None,
        leaf: int = 0,
        host: int = 0,
    ):
        self.nan_steps = frozenset(int(s) for s in nan_steps)
        self.inf_steps = frozenset(int(s) for s in inf_steps)
        self.fail_steps = frozenset(int(s) for s in fail_steps)
        self.preempt_steps = frozenset(int(s) for s in preempt_steps)
        self.preempt_at = preempt_at
        self.leaf = int(leaf)
        self.host = int(host)
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
        leaf: int = 0,
        host: int = 0,
    ) -> "ChaosMonkey":
        """Deterministic random schedule: the same (seed, n_steps, rates)
        yields the same injector on every host and every rerun -- chaos
        that reproduces, and the same schedule as the reference's for the
        same arguments. Step 0 is never selected (the anchor commit stays
        clean, so a rollback always has a target). As serving request ids
        the schedule reads "request 3 decodes a NaN logit once, request 7's
        launch faults once"."""
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
            preempt_steps=preempt_steps, leaf=leaf, host=host,
        )

    def _fire(self, kind: str, step: int) -> bool:
        key = (kind, int(step))
        if key in self.fired:
            return False
        self.fired.add(key)
        return True

    def _poison_value(self, step: int):
        """NaN or Inf iff ``step`` is a configured (unfired) nan/inf step,
        else None; fires it."""
        if step in self.nan_steps and self._fire("nan", step):
            return float("nan")
        if step in self.inf_steps and self._fire("inf", step):
            return float("inf")
        return None

    def corrupt(self, grads, step: int):
        """``grads`` with one element poisoned iff ``step`` is a configured
        (unfired) nan/inf step, else ``grads`` itself. ``grads`` is a tensor
        or a tree of them (``reduce.tree_leaves`` order); the poisoned leaf
        is a copy, the caller's tensors are not written."""
        value = self._poison_value(step)
        if value is None:
            return grads
        from repro_torch.reduce import tree_leaves

        leaves = tree_leaves(grads)
        target = leaves[self.leaf % len(leaves)]

        def rebuild(t):
            if isinstance(t, torch.Tensor):
                if t is not target:
                    return t
                out = t.detach().clone()
                out.view(-1)[0] = value
                return out
            if isinstance(t, dict):
                return {k: rebuild(v) for k, v in t.items()}
            return type(t)(rebuild(v) for v in t)

        return rebuild(grads)

    def corrupt_shard(self, x, step: int, *, shards: int):
        """Per-host corruption of a GLOBAL array that will be split into
        ``shards`` equal pieces along its flattened view: poisons flat
        element 0 of shard ``self.host`` only, iff ``step`` is a configured
        (unfired) nan/inf step. Returns a copy (or ``x`` itself)."""
        value = self._poison_value(step)
        if value is None:
            return x
        if x.numel() % shards:
            raise ValueError(f"array of size {x.numel()} does not split into {shards} "
                             "equal shards")
        out = x.detach().clone()
        out.reshape(shards, -1)[self.host % shards, 0] = value
        return out

    def on_step(self, step: int, guard=None) -> None:
        """Call at the top of each step attempt: raises ``TransientFault``
        on a configured (unfired) fail step; trips ``guard`` at
        ``preempt_at``."""
        self.calls += 1
        if (guard is not None and self.preempt_at is not None and step >= self.preempt_at
                and self._fire("preempt", self.preempt_at)):
            guard.trigger()
        if step in self.fail_steps and self._fire("fail", step):
            raise TransientFault(f"injected transient failure at step {step}")

    # -- per-request serving hooks (same schedule, keyed by request id) --

    def scale_for(self, request_id: int) -> float:
        """Chaos multiplier for one request's decode step: NaN / Inf iff
        ``request_id`` is a configured (unfired) nan/inf id, else 1.0.
        The serving engine multiplies the slot's logits by it -- x1.0 is
        bitwise identity, so a clean request's tokens are untouched and a
        poisoned slot's retry (fire-once) reproduces the clean run."""
        value = self._poison_value(int(request_id))
        return 1.0 if value is None else value

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


class StepGuard:
    """Consecutive-bad-step counter and bounded-backoff retry policy.

    ``retry(fn, ...)`` wraps each step attempt (``TransientFault`` -> sleep
    ``backoff_s * 2^attempt`` capped at ``backoff_cap_s``, up to
    ``max_retries`` retries, then re-raise); ``record(skipped)`` tracks the
    guarded optimizer's skip flag; after ``max_bad_steps`` CONSECUTIVE
    skips ``should_rollback()`` turns true and the loop restores the last
    committed checkpoint (then calls ``reset()``). ``sleep`` is injectable
    so tests check the schedule without waiting."""

    def __init__(
        self,
        max_bad_steps: int = 3,
        *,
        max_retries: int = 3,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_bad_steps < 1:
            raise ValueError(f"max_bad_steps must be >= 1; got {max_bad_steps}")
        self.max_bad_steps = int(max_bad_steps)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self.consecutive_bad = 0
        self.transient_failures = 0
        self.rollbacks = 0

    def retry(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying ``TransientFault`` with
        bounded exponential backoff; any other exception propagates at once
        (a poisoned step is not transient: it must reach the skip and
        rollback machinery, not be retried)."""
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except TransientFault:
                self.transient_failures += 1
                if attempt == self.max_retries:
                    raise
                self._sleep(delay)
                delay = min(delay * 2.0, self.backoff_cap_s)

    def record(self, skipped: bool) -> None:
        self.consecutive_bad = self.consecutive_bad + 1 if skipped else 0

    def should_rollback(self) -> bool:
        return self.consecutive_bad >= self.max_bad_steps

    def reset(self) -> None:
        self.consecutive_bad = 0
