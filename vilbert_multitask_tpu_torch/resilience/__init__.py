"""resilience/ — failure-domain policy + deterministic fault injection.

Policy half (:mod:`.policy`): deadlines that ride the job body, the shared
retry loop (full jitter + process budget), circuit breakers, and the HTTP
admission controller. Faults half (:mod:`.faults`): seeded `fault_point`
sites on production paths for reproducible chaos. Host-side stdlib + obs
only — no torch, no jax.
"""

from vilbert_multitask_tpu_torch.resilience.policy import (
    AdmissionController,
    AdmissionDecision,
    BreakerBoard,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
    PROCESS_RETRY_BUDGET,
    ReplicaKilled,
    RetryBudget,
    RetryPolicy,
)
from vilbert_multitask_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    FaultRule,
    active_plan,
    clear_plan,
    fault_point,
    install_plan,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "BreakerBoard",
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "PROCESS_RETRY_BUDGET",
    "ReplicaKilled",
    "RetryBudget",
    "RetryPolicy",
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "active_plan",
    "clear_plan",
    "fault_point",
    "install_plan",
]
