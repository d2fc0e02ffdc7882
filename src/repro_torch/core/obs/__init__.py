"""Deterministic observability layer for the cluster simulator.

`TraceRecorder` collects spans (job lifecycle, device occupancy, reconfig
windows), decision-provenance instants (every admission / veto / replan /
gang / forecast action with the *why*), counter series sampled on event
boundaries, and measured-vs-predicted step samples — all driven purely by
sim time, so a traced run is byte-deterministic per seed and a trace-off
run is byte-identical to an untraced one.

Exporters render the recorder into Chrome-trace-event JSON (loadable at
https://ui.perfetto.dev) or a flat counter-series document.
"""

from repro_torch.core.obs.perfetto import EXPORTERS, export_counters, export_perfetto
from repro_torch.core.obs.recorder import PROVENANCE, TraceRecorder

__all__ = [
    "EXPORTERS",
    "PROVENANCE",
    "TraceRecorder",
    "export_counters",
    "export_perfetto",
]
