"""Serving runtime: chaos injection, metrics, the guarded serving loop."""

from repro_torch.runtime.chaos import ChaosMonkey, Preemption, TransientFault  # noqa: F401
from repro_torch.runtime.metrics import GuardMetrics, ServeMetrics  # noqa: F401
from repro_torch.runtime.serving import (  # noqa: F401
    DEFAULT_BACKEND_CHAIN,
    AdmissionQueue,
    CircuitBreaker,
    Completion,
    DeadlineExceeded,
    Request,
    RequestRejected,
    ServingRuntime,
    guarded_logit_stat,
)
