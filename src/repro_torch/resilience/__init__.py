"""repro_torch.resilience — numeric health guards, graceful wire degradation,
loss-spike rollback, and the fault-injection harness that proves them.

Counterpart of ``repro/resilience``; README.md in this directory gives the
failure-mode matrix with each row's port test.
"""

from repro_torch.resilience import guards  # noqa: F401
from repro_torch.resilience.guards import (  # noqa: F401
    GuardConfig, GuardState, HEALTH_LOSS_NONFINITE, HEALTH_GRADS_NONFINITE,
    HEALTH_OVERFLOW_STORM, HEALTH_GRAD_SPIKE, HEALTH_FL_RAIL,
    HEALTH_IL_RATCHET, HEALTH_DEGRADED, HEALTH_SKIPPED, domain_overflow,
    global_norm, health_flags, init_guard_state, nonfinite_any, step_ok,
    update_guard, wire_domains, widen_on_trip)
from repro_torch.resilience.inject import (  # noqa: F401
    FaultPlan, apply_grad_faults, corrupt_checkpoint, payload_fault_fn)
