"""Runtime: chaos injection, guard metrics, the guarded serving loop, the
fault tolerance of the training loop (retry, skip accounting, rollback,
preemption, resume), and the cross-rank agreement checker."""

from repro_torch.runtime.agreement import (  # noqa: F401
    AgreementChecker,
    DivergenceError,
    FileTransport,
    Transport,
    exchange,
    fingerprint,
    step_fingerprint,
)
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosMonkey,
    Preemption,
    StepGuard,
    TransientFault,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    ElasticPlan,
    HeartbeatTracker,
    PreemptionGuard,
    TrainSupervisor,
)
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
