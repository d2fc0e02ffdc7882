# The paper's primary contribution — the scheduling system (PyTorch twin of
# ``repro.core``): the device model, the shared-mode models, the workload
# API, the placement planner, the instance runtime on the card, the
# isolation checks, and the event-driven cluster with its queueing,
# forecasting, tracing and calibration subsystems.

# Device-model API: first-class GPU SKU descriptors (placement tree,
# slice budgets, shared-mode knobs) + the registry of generations.
from repro_torch.core.device import (  # noqa: F401
    DEFAULT_SKU,
    SKUS,
    DeviceSKU,
    InstanceProfile,
    Placement,
    format_gib,
    get_sku,
)

# Public mode API.
from repro_torch.core.sharing import (  # noqa: F401
    CollocationMode,
    SharedModeReport,
    SoloProfile,
    device_busy_fraction,
    mps_contention,
    naive_contention,
    shared_mode_report,
)

# Event-driven cluster API (dynamic arrivals, per-device modes, live
# reconfiguration). The cluster does no device work (only
# core/instance.py's InstanceRuntime does), so the simulator runs on the
# host alone.
from repro_torch.core.cluster import (  # noqa: F401
    Cluster,
    ClusterJob,
    ClusterReport,
    DeviceState,
)
from repro_torch.core.events import Event, EventKind, EventQueue  # noqa: F401
from repro_torch.core.queueing import AdmissionQueue  # noqa: F401

# Workload API v2: phase-aware demand traces, TRAIN/SERVE objectives, and
# the flat-JobSpec single-phase adapter.
from repro_torch.core.workload import (  # noqa: F401
    DemandTrace,
    Phase,
    PhaseSpan,
    Workload,
    WorkloadKind,
    as_workload,
    from_jobspec,
    serve_workload,
    train_workload,
)
