"""Sim-time trace recorder with decision provenance.

The recorder is a passive sink: the cluster (and the admission queue it
owns) pushes spans, instants, counters, and step samples into it at the
sim times the events happen. Nothing here reads wall clocks, allocates
ids from global state, or mutates scheduler state — recording the same
run twice yields byte-identical exports, and running with the recorder
detached yields byte-identical artifacts.

Three invariants the rest of the repo relies on:

- **No-op when disabled.** Every record method starts with
  ``if not self.enabled: return`` before touching its arguments, so a
  disabled recorder does zero allocation on the hot path.
- **Provenance completeness.** Decision instants whose name appears in
  :data:`PROVENANCE` must carry every required arg key; ``instant()``
  raises ``ValueError`` otherwise, so a hook that forgets the *why*
  fails loudly in tests rather than shipping an unexplained decision.
- **Sim time only.** All timestamps are the caller's ``t`` in seconds;
  the recorder never invents one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

# Required arg keys per decision-instant name. Hooks may add extra keys
# (e.g. a migrate records its trigger ``kind``); missing a required key
# raises at record time. tests/test_obs.py asserts both directions.
PROVENANCE: Dict[str, Tuple[str, ...]] = {
    # queueing.py — admission, backfill, reservations, pre-warm holds
    "enqueue": ("job", "priority", "depth"),
    "reject": ("job", "reason"),
    "dispatch": ("job", "device", "wait_s"),
    "backfill_overtake": ("job",),
    "veto_reserved": ("job", "device", "held_by"),
    "veto_prewarm": ("job", "device", "warmed_for"),
    "prewarm": ("device", "kind"),
    "prewarm_release": ("device",),
    # cluster.py — mode migrations and planner replans
    "migrate": ("device", "from", "to", "requeued", "cost_s"),
    "replan": (
        "device",
        "kept",
        "requeued",
        "placed",
        "layout",
        "optimality",
        "gap",
        "configs_evaluated",
    ),
    "straggler_repack": ("job", "device", "min_profile"),
    # gang/placement.py — all-or-nothing outcomes
    "gang_reserve": ("gang", "devices"),
    "gang_release": ("gang",),
    "gang_place": ("gang", "devices", "spread", "step_s", "comm_s"),
    "gang_blocked": ("gang", "world_size"),
    "gang_reject": ("gang", "reason"),
    # forecast/policy.py — predicted band vs realized arrivals
    "forecast_tick": (
        "rate_per_s",
        "lower_per_s",
        "upper_per_s",
        "realized_per_s",
        "abs_err_per_s",
        "in_band",
    ),
}


class TraceRecorder:
    """Accumulates one run's trace; export via ``repro.core.obs.perfetto``.

    Storage is plain lists/dicts of primitives so exports are cheap and
    deterministic:

    - ``spans``: ``(track, name, cat, t0_s, t1_s, args)`` tuples,
      appended when the interval *closes*.
    - ``instants``: ``(track, name, cat, t_s, args)`` tuples.
    - ``counters``: ``{name: [(t_s, value), ...]}`` — every sample is
      kept (the Perfetto exporter collapses consecutive duplicates).
    - ``samples``: measured-vs-predicted step-time dicts, the data
      source for the char-DB calibration item.
    """

    __slots__ = ("enabled", "tracks", "_track_set", "spans", "instants", "counters", "samples")

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.tracks: List[str] = []
        self._track_set: set = set()
        self.spans: List[Tuple[str, str, str, float, float, Optional[Mapping[str, Any]]]] = []
        self.instants: List[Tuple[str, str, str, float, Optional[Mapping[str, Any]]]] = []
        self.counters: Dict[str, List[Tuple[float, Any]]] = {}
        self.samples: List[Dict[str, Any]] = []

    # -- registration ----------------------------------------------------

    def track(self, name: str) -> None:
        """Pre-register a track so exports list it in a stable order."""
        if not self.enabled:
            return
        if name not in self._track_set:
            self._track_set.add(name)
            self.tracks.append(name)

    # -- record methods --------------------------------------------------

    def span(
        self,
        track: str,
        name: str,
        t0_s: float,
        t1_s: float,
        *,
        cat: str = "span",
        args: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Record a closed interval ``[t0_s, t1_s]`` on ``track``."""
        if not self.enabled:
            return
        self.track(track)
        self.spans.append((track, name, cat, t0_s, t1_s, args))

    def instant(
        self,
        track: str,
        name: str,
        t_s: float,
        *,
        cat: str = "decision",
        args: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Record a point event; validates :data:`PROVENANCE` args."""
        if not self.enabled:
            return
        required = PROVENANCE.get(name)
        if required is not None:
            have = args or {}
            missing = [k for k in required if k not in have]
            if missing:
                raise ValueError(
                    f"decision instant {name!r} missing provenance keys {missing}"
                )
        self.track(track)
        self.instants.append((track, name, cat, t_s, args))

    def counter(self, name: str, t_s: float, value: Any) -> None:
        """Append one sample to the counter series ``name``."""
        if not self.enabled:
            return
        series = self.counters.get(name)
        if series is None:
            series = self.counters[name] = []
        series.append((t_s, value))

    def step_sample(
        self,
        t_s: float,
        job: str,
        arch: str,
        profile: str,
        measured_s: float,
        predicted_s: float,
        *,
        source: str,
    ) -> None:
        """Record a measured-vs-predicted step-time pair.

        ``source`` is ``"observe"`` for live `Cluster.observe_step`
        telemetry and ``"completion"`` for the lifetime-average sample
        the cluster emits when a job drains.
        """
        if not self.enabled:
            return
        self.samples.append(
            {
                "t_s": t_s,
                "job": job,
                "arch": arch,
                "profile": profile,
                "measured_s": measured_s,
                "predicted_s": predicted_s,
                "source": source,
            }
        )

    # -- convenience -----------------------------------------------------

    def instants_named(self, name: str) -> List[Tuple[str, str, str, float, Optional[Mapping[str, Any]]]]:
        """All recorded instants with the given decision name."""
        return [rec for rec in self.instants if rec[1] == name]

    def __len__(self) -> int:
        n_counters = sum(len(s) for s in self.counters.values())
        return len(self.spans) + len(self.instants) + n_counters + len(self.samples)
