"""Resilient serving runtime: admission control, deadlines, census-guarded
decode, and per-backend circuit breaking.

A copy of ``repro/runtime/serving.py`` whose degradation chain is the
port's: ``cuda_fused -> mma_torch -> torch``, and whose
``guarded_logit_stat`` runs ``repro_torch.reduce.reduce_tree``.

  admission      -- a bounded FIFO with load shedding (``AdmissionQueue``)
                    and deadline feasibility from an EWMA step time.
  census guard   -- every step's logit statistic rides
                    ``reduce_tree(census=True)`` (``guarded_logit_stat``):
                    the SAME launch that computes the statistic counts
                    NaN/Inf logits per slot. A poisoned slot is quarantined
                    for the step and the step retried from the committed
                    state.
  circuit breaker-- repeated ``TransientFault``s trip a per-backend breaker
                    (``CircuitBreaker``) that degrades along the chain and
                    probes the failed backend half-open after a bounded
                    exponential cooldown; tripping also quarantines the
                    backend in the planner. Only ``TransientFault`` (raised
                    by the chaos injector) is caught: a CUDA error is never
                    turned into one and propagates.
  observability  -- ``ServeMetrics`` exported through ``--status-path``.

Engine protocol::

    engine.slots                       # int, batch width
    engine.validate(prompt, max_new)   # -> error str | None
    engine.start_wave(prompts, scales, backend) -> (state, tokens, census)
    engine.decode(state, scales, backend) -> (state', tokens, census)

``census`` holds the per-slot non-finite counts with the total in the last
slot (``guarded_logit_stat``'s layout). The runtime re-issues a step from
the same ``state`` on retry, so a retried step must reproduce the clean
step; ``launch.serve.GuardedEngine`` writes its KV caches in place and
relies on that write being idempotent (see ``models.attention``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

from repro_torch import reduce as R

from repro_torch.runtime.chaos import ChaosMonkey, Preemption, TransientFault
from repro_torch.runtime.metrics import ServeMetrics

# The default degradation order: the kernel backend first, the all-ones
# matmul algorithm behind it, plain torch terminal.
DEFAULT_BACKEND_CHAIN = ("cuda_fused", "mma_torch", "torch")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``deadline_s`` is ABSOLUTE on the runtime's
    clock (``None`` = no deadline); the CLI converts relative timeouts."""

    rid: int
    prompt: object  # token array (np.ndarray); opaque to the runtime
    max_new: int
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    tokens: tuple

    @property
    def ok(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class RequestRejected:
    """Refused before (admission/feasibility/validation) or during
    (persistently poisoned slot) service; ``reason`` says which."""

    rid: int
    reason: str
    tokens: tuple = ()

    @property
    def ok(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """Ran out of deadline; ``tokens`` carries whatever was decoded in
    time (empty if shed while still queued)."""

    rid: int
    tokens: tuple = ()

    @property
    def ok(self) -> bool:
        return False


class AdmissionQueue:
    """Bounded FIFO with shed-oldest-past-deadline-first load shedding.

    ``submit`` returns ``(admitted, shed)``: when the queue is full it
    first sheds queued requests already past their deadline (oldest
    first) to make room -- they are the cheapest loss, the new arrival
    still has its whole deadline ahead. Only if nobody is sheddable is
    the new request itself refused."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._q: list = []

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request, now: float):
        shed = []
        while len(self._q) >= self.capacity:
            victim_i = next(
                (
                    i
                    for i, r in enumerate(self._q)
                    if r.deadline_s is not None and now > r.deadline_s
                ),
                None,
            )
            if victim_i is None:
                return False, shed
            shed.append(self._q.pop(victim_i))
        self._q.append(req)
        return True, shed

    def pop(self, n: int, now: float):
        """Up to ``n`` requests for the next wave, dropping (and returning
        as ``expired``) queued requests already past deadline: they would
        only waste slots. -> (wave, expired)."""
        wave, expired = [], []
        while self._q and len(wave) < n:
            r = self._q.pop(0)
            if r.deadline_s is not None and now > r.deadline_s:
                expired.append(r)
            else:
                wave.append(r)
        return wave, expired


class CircuitBreaker:
    """Per-backend closed -> open -> half-open breaker over a degradation
    chain.

    ``backend()`` returns the first usable backend in ``chain``: a CLOSED
    one, or an OPEN one whose bounded-exponential cooldown has elapsed
    (it turns HALF_OPEN and gets probe traffic). ``fail_threshold``
    consecutive ``record_failure`` calls trip a backend OPEN (the
    ``on_trip`` hook fires -- the runtime wires it to
    ``reduce.quarantine_backend`` so stale auto plans cannot resurrect
    it); a half-open probe failing re-opens with the cooldown doubled (up
    to ``cooldown_cap_s``); ``probe_successes`` clean probes close it
    (``on_close`` -> ``reinstate_backend``). The chain's LAST backend is
    never refused -- something must serve."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        chain: Sequence[str] = DEFAULT_BACKEND_CHAIN,
        *,
        fail_threshold: int = 3,
        cooldown_s: float = 0.5,
        cooldown_cap_s: float = 30.0,
        probe_successes: int = 2,
        clock: Callable[[], float] = time.monotonic,
        on_trip: Optional[Callable[[str], None]] = None,
        on_close: Optional[Callable[[str], None]] = None,
    ):
        if not chain:
            raise ValueError("backend chain must be non-empty")
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold must be >= 1; got {fail_threshold}")
        self.chain = tuple(chain)
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.probe_successes = int(probe_successes)
        self._clock = clock
        self._on_trip = on_trip
        self._on_close = on_close
        self.total_trips = 0
        self._st = {
            name: {
                "state": self.CLOSED,
                "fails": 0,
                "opened_at": 0.0,
                "cooldown": self.cooldown_s,
                "probes": 0,
            }
            for name in self.chain
        }

    def backend(self) -> str:
        now = self._clock()
        for name in self.chain[:-1]:
            st = self._st[name]
            if st["state"] == self.CLOSED:
                return name
            if st["state"] == self.OPEN:
                if now - st["opened_at"] >= st["cooldown"]:
                    st["state"] = self.HALF_OPEN
                    st["probes"] = 0
                    return name
                continue
            return name  # HALF_OPEN keeps probing until verdict
        return self.chain[-1]

    def _trip(self, name: str, st: dict) -> None:
        st["state"] = self.OPEN
        st["opened_at"] = self._clock()
        st["fails"] = 0
        st["probes"] = 0
        self.total_trips += 1
        if self._on_trip is not None:
            self._on_trip(name)

    def record_failure(self, name: str) -> None:
        st = self._st.get(name)
        if st is None:
            return
        if st["state"] == self.HALF_OPEN:
            # failed probe: back to OPEN, cooldown doubled (bounded)
            st["cooldown"] = min(st["cooldown"] * 2.0, self.cooldown_cap_s)
            self._trip(name, st)
            return
        if st["state"] == self.CLOSED:
            st["fails"] += 1
            if st["fails"] >= self.fail_threshold:
                st["cooldown"] = self.cooldown_s
                self._trip(name, st)

    def record_success(self, name: str) -> None:
        st = self._st.get(name)
        if st is None:
            return
        if st["state"] == self.HALF_OPEN:
            st["probes"] += 1
            if st["probes"] >= self.probe_successes:
                st["state"] = self.CLOSED
                st["fails"] = 0
                st["cooldown"] = self.cooldown_s
                if self._on_close is not None:
                    self._on_close(name)
        elif st["state"] == self.CLOSED:
            st["fails"] = 0

    def state(self, name: str) -> str:
        return self._st[name]["state"]

    def states(self) -> dict:
        return {name: st["state"] for name, st in self._st.items()}


def _planner_trip(name: str) -> None:
    R.quarantine_backend(name)


def _planner_close(name: str) -> None:
    R.reinstate_backend(name)


def guarded_logit_stat(logits, *, backend: Optional[str] = None):
    """Per-slot logit sumsq + in-launch non-finite census, ONE launch.

    ``logits``: (B, ...) slot-major logits (an audio arch's (B, 1, K, V):
    a slot's K streams are one leaf). Each slot enters the parts
    kernel as its own leaf (a view: no copy), so the return is
    ``(stat, counts)``: per-slot sum of squares (B,) and per-slot NaN/Inf
    counts with the cross-slot total appended (B + 1,). On cuda_fused this
    is one kernel launch that reads the logits once; the census tells the
    runtime WHICH slot to quarantine. ``backend=None`` lets the planner
    choose (quarantined backends excluded); the breaker passes its
    selection explicitly."""
    leaves = [logits[i] for i in range(logits.shape[0])]
    stat, _totals, counts = R.reduce_tree(
        leaves, "sumsq", backend=backend, return_per_leaf=True, census=True,
    )
    return stat, counts


class ServingRuntime:
    """The guarded serving loop over any protocol-conforming engine.

    ``serve(requests)`` admits through the bounded queue, packs waves of
    ``engine.slots``, and for every step: checks deadlines, applies the
    chaos schedule (per-request, fire-once), runs the engine step on the
    breaker's backend, and commits state ONLY if the step's census is
    clean for every live slot -- otherwise the poisoned slots are
    quarantined for the step and the step retried from the committed
    state (``max_step_retries`` bounds it; slots still poisoned on the
    final attempt fail as ``RequestRejected('poisoned')`` while the rest
    of the batch proceeds). ``TransientFault`` retries charge the
    breaker; ``Preemption`` retries are free. All timing flows through
    the injectable ``clock`` so every schedule is testable without
    wall-clock waits."""

    def __init__(
        self,
        engine,
        *,
        queue_capacity: int = 64,
        breaker: Optional[CircuitBreaker] = None,
        chaos: Optional[ChaosMonkey] = None,
        metrics: Optional[ServeMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        max_step_retries: int = 4,
        status_path=None,
        quarantine_planner: bool = True,
    ):
        self.engine = engine
        self.queue = AdmissionQueue(queue_capacity)
        if breaker is None:
            breaker = CircuitBreaker(
                clock=clock,
                on_trip=_planner_trip if quarantine_planner else None,
                on_close=_planner_close if quarantine_planner else None,
            )
        self.breaker = breaker
        self.chaos = chaos
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.clock = clock
        self.max_step_retries = int(max_step_retries)
        self.status_path = status_path
        # EWMA of one decode step's wall time; None until the first wave
        # has been measured (feasibility refusals need real evidence).
        self._step_ewma: Optional[float] = None
        self._results: dict = {}

    # -- admission ---------------------------------------------------------

    def _estimate_serve_s(self, req: Request) -> Optional[float]:
        if self._step_ewma is None:
            return None
        # queued waves ahead of this request, plus its own wave's steps
        waves_ahead = math.ceil((len(self.queue) + 1) / self.engine.slots)
        return self._step_ewma * req.max_new * waves_ahead

    def submit(self, req: Request) -> bool:
        """Admit ``req`` or record a structured refusal. Returns True iff
        admitted (the result then arrives via ``serve``'s drain)."""
        now = self.clock()
        err = None
        validate = getattr(self.engine, "validate", None)
        if validate is not None:
            err = validate(req.prompt, req.max_new)
        if err:
            self._results[req.rid] = RequestRejected(req.rid, err)
            self.metrics.record_shed(infeasible=True)
            return False
        if req.deadline_s is not None:
            est = self._estimate_serve_s(req)
            if now > req.deadline_s or (
                est is not None and now + est > req.deadline_s
            ):
                self._results[req.rid] = RequestRejected(
                    req.rid,
                    "infeasible: deadline cannot be met "
                    f"(estimated {est if est is not None else 0.0:.4f}s)",
                )
                self.metrics.record_shed(infeasible=True)
                return False
        admitted, shed = self.queue.submit(req, now)
        for victim in shed:
            self._results[victim.rid] = DeadlineExceeded(victim.rid)
            self.metrics.record_deadline_miss()
        if not admitted:
            self._results[req.rid] = RequestRejected(
                req.rid, f"queue full (capacity {self.queue.capacity})"
            )
            self.metrics.record_shed()
            return False
        self.metrics.record_admit()
        return True

    # -- the guarded step --------------------------------------------------

    def _chaos_precheck(self, rids) -> None:
        if self.chaos is None:
            return
        for rid in rids:
            self.chaos.on_request(rid)

    def _scales(self, wave) -> list:
        scales = []
        for slot in wave:
            if slot is None or self.chaos is None:
                scales.append(1.0)
            else:
                scales.append(self.chaos.scale_for(slot.rid))
        return scales

    def _guarded_call(self, wave, live, call):
        """Run one engine step until its census is clean for every live
        slot (or retries run out). ``call(scales, backend)`` issues the
        step from the COMMITTED state. Returns (state, tokens, poisoned):
        ``poisoned`` is the set of slot indices still non-finite on the
        final attempt (their state never commits -- they are dead)."""
        last_poisoned: set = set()
        for attempt in range(self.max_step_retries + 1):
            backend = self.breaker.backend()
            try:
                self._chaos_precheck(
                    wave[i].rid for i in sorted(live)
                )
                scales = self._scales(
                    [wave[i] if i in live else None for i in range(len(wave))]
                )
                state, tokens, census = call(scales, backend)
            except Preemption:
                self.metrics.record_retry()
                continue
            except TransientFault:
                self.breaker.record_failure(backend)
                self.metrics.record_retry()
                continue
            poisoned = {
                i for i in live if float(census[i]) > 0.0
            }
            if not poisoned:
                self.breaker.record_success(backend)
                return state, tokens, set()
            self.metrics.record_quarantine(len(poisoned))
            self.metrics.record_retry()
            last_poisoned = poisoned
            if attempt == self.max_step_retries:
                return state, tokens, poisoned
        # every attempt raised: surface the persistent fault
        raise TransientFault(
            f"step failed after {self.max_step_retries + 1} attempts "
            f"(breaker states: {self.breaker.states()})"
        )

    # -- the wave loop -----------------------------------------------------

    def _finish(self, req: Request, tokens: list) -> None:
        self._results[req.rid] = Completion(req.rid, tuple(tokens))
        self.metrics.record_completed(len(tokens))

    def _run_wave(self, wave_reqs) -> None:
        slots = self.engine.slots
        wave = list(wave_reqs) + [None] * (slots - len(wave_reqs))
        live = {i for i, r in enumerate(wave) if r is not None}
        toks: dict = {i: [] for i in live}
        max_new = max(r.max_new for r in wave_reqs)

        def expire(now: float) -> None:
            for i in sorted(live):
                r = wave[i]
                if r.deadline_s is not None and now > r.deadline_s:
                    self._results[r.rid] = DeadlineExceeded(
                        r.rid, tuple(toks[i])
                    )
                    self.metrics.record_deadline_miss()
                    live.discard(i)

        def kill_poisoned(poisoned) -> None:
            for i in sorted(poisoned):
                r = wave[i]
                self._results[r.rid] = RequestRejected(
                    r.rid,
                    "poisoned: non-finite logits persisted across "
                    f"{self.max_step_retries + 1} attempts",
                    tuple(toks[i]),
                )
                self.metrics.record_poisoned()
                live.discard(i)

        prompts = [r.prompt if r is not None else None for r in wave]
        t0 = self.clock()
        expire(t0)
        if not live:
            return
        state, tokens, poisoned = self._guarded_call(
            wave, live, lambda scales, backend: self.engine.start_wave(
                prompts, scales, backend
            )
        )
        self._record_step_time(self.clock() - t0)
        kill_poisoned(poisoned)
        for i in live:
            if len(toks[i]) < wave[i].max_new:
                toks[i].append(int(tokens[i]))
        for t in range(1, max_new):
            done = {i for i in live if len(toks[i]) >= wave[i].max_new}
            for i in sorted(done):
                self._finish(wave[i], toks[i])
                live.discard(i)
            expire(self.clock())
            if not live:
                break
            t1 = self.clock()
            new_state, tokens, poisoned = self._guarded_call(
                wave, live, lambda scales, backend: self.engine.decode(
                    state, scales, backend
                )
            )
            self._record_step_time(self.clock() - t1)
            state = new_state
            kill_poisoned(poisoned)
            for i in live:
                toks[i].append(int(tokens[i]))
        for i in sorted(live):
            self._finish(wave[i], toks[i])

    def _record_step_time(self, dt: float) -> None:
        self.metrics.record_token_latency(dt)
        if self._step_ewma is None:
            self._step_ewma = dt
        else:
            self._step_ewma = 0.8 * self._step_ewma + 0.2 * dt

    def _export(self) -> None:
        self.metrics.breaker_trips = self.breaker.total_trips
        self.metrics.record_breaker_states(self.breaker.states())
        if self.status_path is not None:
            self.metrics.write(self.status_path)

    def serve(self, requests: Sequence[Request]):
        """Admit + drain: returns one structured result PER REQUEST, in
        request order -- ``Completion`` | ``RequestRejected`` |
        ``DeadlineExceeded``. Never raises on a bad request; the engine
        erroring persistently (every backend, every retry) does raise
        ``TransientFault`` -- at that point nothing can serve."""
        for req in requests:
            self.submit(req)
        self.drain()
        return [self._results[r.rid] for r in requests]

    def drain(self) -> None:
        """Run queued waves to completion, exporting status every wave."""
        while len(self.queue):
            wave, expired = self.queue.pop(self.engine.slots, self.clock())
            for r in expired:
                self._results[r.rid] = DeadlineExceeded(r.rid)
                self.metrics.record_deadline_miss()
            if wave:
                self._run_wave(wave)
            self._export()
        self._export()
