"""Exporters: Chrome-trace-event JSON (Perfetto) and flat counter series.

`export_perfetto` renders a :class:`~repro.core.obs.recorder.TraceRecorder`
into the Chrome trace-event format that https://ui.perfetto.dev loads
directly: one "thread" (track) per device plus the scheduler-decision,
queue, and jobs tracks. Spans use async begin/end pairs so overlapping
occupancy intervals on one device render side by side instead of being
forced into a call-stack nesting; instants and counters use the ``i``
and ``C`` phases.

`export_counters` is the flat companion: raw ``(t, value)`` series plus
the measured-vs-predicted step samples, for scripting without a trace
viewer.

Both exporters are pure functions of the recorder, and all floats are
rounded before serialization, so same-seed runs export byte-identical
documents.
"""

from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.core.obs.recorder import TraceRecorder

COUNTERS_SCHEMA = "obs_counters/v1"


def _us(t_s: float) -> float:
    """Sim seconds -> trace microseconds, rounded for byte stability."""
    return round(t_s * 1e6, 3)


def _round_args(args: Any) -> Any:
    if isinstance(args, float):
        return round(args, 9)
    if isinstance(args, dict):
        return {k: _round_args(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return [_round_args(v) for v in args]
    return args


def export_perfetto(rec: TraceRecorder) -> Dict[str, Any]:
    """Render the recorder as a Chrome-trace-event document."""
    tids: Dict[str, int] = {}

    def tid(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
        return t

    for track in rec.tracks:
        tid(track)

    events: List[Dict[str, Any]] = []
    for i, (track, name, cat, t0, t1, args) in enumerate(rec.spans):
        begin: Dict[str, Any] = {
            "ph": "b",
            "cat": cat,
            "id": i + 1,
            "name": name,
            "pid": 1,
            "tid": tid(track),
            "ts": _us(t0),
        }
        if args:
            begin["args"] = _round_args(args)
        events.append(begin)
        events.append(
            {
                "ph": "e",
                "cat": cat,
                "id": i + 1,
                "name": name,
                "pid": 1,
                "tid": tid(track),
                "ts": _us(t1),
            }
        )
    for track, name, cat, t, args in rec.instants:
        ev: Dict[str, Any] = {
            "ph": "i",
            "s": "t",
            "cat": cat,
            "name": name,
            "pid": 1,
            "tid": tid(track),
            "ts": _us(t),
        }
        if args:
            ev["args"] = _round_args(args)
        events.append(ev)
    for cname in sorted(rec.counters):
        last: Any = object()
        for t, value in rec.counters[cname]:
            if value == last:
                continue  # collapse flat stretches; the flat export keeps them
            last = value
            events.append(
                {
                    "ph": "C",
                    "name": cname,
                    "pid": 1,
                    "ts": _us(t),
                    "args": {"value": _round_args(value)},
                }
            )

    meta: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "cluster-sim"}}
    ]
    for track, t in tids.items():
        meta.append(
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": t, "args": {"name": track}}
        )
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


def export_counters(rec: TraceRecorder) -> Dict[str, Any]:
    """Render the recorder as a flat counter/sample document."""
    return {
        "schema": COUNTERS_SCHEMA,
        "counters": {
            name: [[round(t, 9), _round_args(v)] for t, v in series]
            for name, series in rec.counters.items()
        },
        "samples": [_round_args(s) for s in rec.samples],
        "totals": {
            "spans": len(rec.spans),
            "instants": len(rec.instants),
            "tracks": list(rec.tracks),
        },
    }


# Exporter registry, keyed by the `simulate.py --trace-exporter` choice.
EXPORTERS = {
    "perfetto": export_perfetto,
    "counters": export_counters,
}
