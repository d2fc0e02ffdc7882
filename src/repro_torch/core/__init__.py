# The paper's primary contribution — the scheduling system (PyTorch twin of
# ``repro.core``). This package holds what the collocation characterization
# needs: the device model, the shared-mode models, the workload API, the
# placement planner, the instance runtime on the card and the isolation
# checks. The reference's event-driven cluster (``cluster``, ``events``,
# ``queueing``, ``elastic``) and ``forecast/``, ``obs/``, ``calib/`` and
# ``gang/placement.py`` are not ported yet (ROADMAP.md, Queue 1 item 13), so
# ``Cluster``, ``ClusterJob``, ``ClusterReport``, ``DeviceState``, ``Event``,
# ``EventKind``, ``EventQueue`` and ``AdmissionQueue`` are not exported.

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
