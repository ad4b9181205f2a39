"""repro_torch.serve — the resilient resident study service (PyTorch port
of :mod:`repro.serve`, the same names).

A long-lived server wrapping the Study planner in a hardened request
loop: bounded-queue admission with load shedding, per-request deadlines,
retry with deterministic backoff, graceful degradation to the sequential
engine, crash-safe warm restart (:mod:`repro_torch.serve.warm` says what
"warm" means in the port), and fault-isolated cross-request lane
coalescing (:mod:`repro_torch.serve.coalesce`) with bisection rollback and
per-lane result integrity.  The deterministic fault-injection harness
lives in :mod:`repro_torch.serve.chaos`.  The server runs on the CUDA card
unless ``ServeConfig(device="cpu")`` is given.
"""

from repro_torch.serve.chaos import (
    ALL_FAULT_CLASSES,
    COALESCE_FAULT_CLASSES,
    FAULT_CLASSES,
    ChaosConfig,
    ChaosMonkey,
    InjectedEngineError,
    SimulatedCrash,
    make_storm,
)
from repro_torch.serve.clock import VirtualClock, WallClock
from repro_torch.serve.coalesce import (
    BLESSED_LANE_WIDTHS,
    GroupKey,
    LaneSlice,
    audit_sample,
    blessed_width,
    group_key,
    group_warm_entries,
    stack_group,
)
from repro_torch.serve.policy import (
    AdaptivePolicy,
    PolicyConfig,
    ServiceModel,
    Telemetry,
)
from repro_torch.serve.queueing import BoundedQueue
from repro_torch.serve.request import (
    CRASHED,
    FAILED,
    OK,
    OK_DEGRADED,
    QUARANTINED,
    REJECTED,
    REJECTED_MALFORMED,
    REJECTED_OVERLOAD,
    REJECTED_OVERSIZED,
    SERVED,
    TERMINAL,
    TIMEOUT,
    Response,
    StudyRequest,
    build_study,
)
from repro_torch.serve.retry import RetryPolicy
from repro_torch.serve.server import (
    WORKER,
    DeadlineExceeded,
    ServeConfig,
    StudyServer,
    restart_server,
)
from repro_torch.serve.warm import (
    ManifestCorruptError,
    WarmCache,
    enable_persistent_cache,
)

__all__ = [
    "ALL_FAULT_CLASSES",
    "COALESCE_FAULT_CLASSES",
    "FAULT_CLASSES",
    "ChaosConfig",
    "ChaosMonkey",
    "InjectedEngineError",
    "SimulatedCrash",
    "make_storm",
    "VirtualClock",
    "WallClock",
    "BLESSED_LANE_WIDTHS",
    "GroupKey",
    "LaneSlice",
    "audit_sample",
    "blessed_width",
    "group_key",
    "group_warm_entries",
    "stack_group",
    "AdaptivePolicy",
    "PolicyConfig",
    "ServiceModel",
    "Telemetry",
    "BoundedQueue",
    "CRASHED",
    "FAILED",
    "OK",
    "OK_DEGRADED",
    "QUARANTINED",
    "REJECTED",
    "REJECTED_MALFORMED",
    "REJECTED_OVERLOAD",
    "REJECTED_OVERSIZED",
    "SERVED",
    "TERMINAL",
    "TIMEOUT",
    "Response",
    "StudyRequest",
    "build_study",
    "RetryPolicy",
    "WORKER",
    "DeadlineExceeded",
    "ServeConfig",
    "StudyServer",
    "restart_server",
    "ManifestCorruptError",
    "WarmCache",
    "enable_persistent_cache",
]
