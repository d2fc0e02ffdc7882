"""Priority + backfill admission queue for the cluster.

Replaces the one-shot scheduler's "reject forever" behaviour: a job that
cannot be placed *now* waits here and is retried on every capacity-changing
event (completion, repair, reconfiguration). Ordering is strict priority
first, then FIFO within a priority class (arrival time, then submission
sequence — the deterministic tie-break the simulator's reproducibility
contract relies on).

Backfill semantics live in the dispatcher (core/cluster.py): the queue is
scanned *in order* and any entry that fits somewhere starts immediately,
even if an earlier (higher-priority) entry is head-of-line blocked waiting
for a big slot. That is classic EASY-style backfill without reservations —
acceptable here because placed jobs never shrink a blocked job's future
options below what the empty device offers, and the paper's queueing-delay
comparison only needs work-conserving admission, not starvation-freedom
guarantees. ``hol_blocked_events`` counts how often backfill overtook a
blocked head — a cheap observability hook for the rigidity analysis.

Gang jobs (core/gang/) are the one exception to "no reservations": an
all-or-nothing k-slice gang CAN be starved by a work-conserving backfill
stream — singletons keep landing on the devices it needs, and capacity
never coincides. After a gang has waited out the cluster's starvation
bound, the dispatcher reserves a concrete device set for it here
(:meth:`reserve`); the dispatcher then refuses to backfill singletons
onto reserved devices, so the set drains and the gang places. At most
one gang holds reservations at a time (the oldest blocked one — that is
what makes the protocol deadlock-free), and a reservation is released
deterministically the moment its gang places or is rejected
(:meth:`release`).

Pre-warm reservations (:meth:`prewarm`) are the forecast policy's
(core/forecast/) second exception, with the opposite shape: not "drain
this device for one waiting job" but "keep this device answering *this
kind* of job". A device warmed for serve traffic ahead of a predicted
ramp would otherwise be backfilled away by queued training long before
the ramp arrives; ``prewarm_blocks`` is the dispatcher's veto that stops
that, while still admitting the kind the device was warmed for. Unlike
gang reservations these are per-device, any number may be live at once,
and they are held across events until the autoscaler releases them.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, FrozenSet, List, Optional


@dataclasses.dataclass
class QueueEntry:
    key: str  # job name — unique within a cluster
    item: Any  # opaque to the queue (the cluster stores its ClusterJob)
    priority: int
    enqueued_s: float
    seq: int

    def sort_key(self):
        return (-self.priority, self.enqueued_s, self.seq)


class AdmissionQueue:
    """Priority queue with stable FIFO order inside each priority class.

    Dispatch order is maintained incrementally (bisect on push, indexed
    delete on remove) rather than re-sorted on every ``ordered()`` call —
    the dispatcher scans the queue on every capacity event, which made the
    O(n log n) re-sort a leading term at city-scale queue depths.
    ``peak_depth`` records the deepest the queue ever got (a burst-pressure
    metric benchmarks/sim_perf.py reports per scenario cell)."""

    def __init__(self) -> None:
        self._entries: Dict[str, QueueEntry] = {}
        self._sorted: List[QueueEntry] = []  # maintained in sort_key order
        self._seq = 0
        self.hol_blocked_events = 0
        self.peak_depth = 0
        # gang reservation state: at most one (gang key, device names)
        # pair at a time — see the module docstring's starvation protocol
        self._reserved_by: Optional[str] = None
        self._reserved_devices: FrozenSet[str] = frozenset()
        self.reservations_made = 0
        self.reservations_released = 0
        # pre-warm reservations (forecast policy): device name -> the job
        # kind the device is warmed for; other kinds are vetoed there
        self._prewarmed: Dict[str, str] = {}
        self.prewarms_made = 0
        self.prewarms_released = 0
        # decision-provenance sink (core/obs/): None means "not traced" and
        # every hook below is a single attribute check
        self._trace = None
        self._trace_clock: Optional[Callable[[], float]] = None

    def attach_trace(self, recorder, clock: Callable[[], float]) -> None:
        """Wire a ``TraceRecorder``. ``clock`` supplies the sim time for
        queue actions whose signatures carry none (reserve/prewarm) —
        the cluster passes its event-loop clock."""
        self._trace = recorder
        self._trace_clock = clock

    def push(self, key: str, item: Any, *, priority: int, enqueued_s: float) -> QueueEntry:
        if key in self._entries:
            raise KeyError(f"{key!r} already queued")
        e = QueueEntry(key, item, int(priority), float(enqueued_s), self._seq)
        self._seq += 1
        self._entries[key] = e
        bisect.insort(self._sorted, e, key=QueueEntry.sort_key)
        if len(self._entries) > self.peak_depth:
            self.peak_depth = len(self._entries)
        if self._trace is not None:
            self._trace.instant(
                "scheduler",
                "enqueue",
                e.enqueued_s,
                args={"job": key, "priority": e.priority, "depth": len(self._entries)},
            )
        return e

    def remove(self, key: str) -> QueueEntry:
        self.release(key)  # leaving the queue always frees the claim
        e = self._entries.pop(key)
        # sort_key ends in the unique push seq, so bisect lands exactly on e
        i = bisect.bisect_left(self._sorted, e.sort_key(), key=QueueEntry.sort_key)
        while self._sorted[i] is not e:  # pragma: no cover - defensive
            i += 1
        del self._sorted[i]
        return e

    def get(self, key: str) -> Optional[QueueEntry]:
        return self._entries.get(key)

    def ordered(self) -> List[QueueEntry]:
        """Entries in dispatch order: priority desc, then FIFO."""
        return list(self._sorted)

    def keys(self) -> List[str]:
        return [e.key for e in self.ordered()]

    def note_backfill_overtake(self) -> None:
        self.hol_blocked_events += 1

    # -- gang reservations ------------------------------------------------

    def reserve(self, key: str, devices) -> None:
        """Reserve ``devices`` for queued gang ``key``. Exclusive: a second
        gang may not reserve until the first's claim is released — queue
        order decides who reserves, which keeps the protocol deadlock-free.
        Re-reserving by the holder replaces its device set (the dispatcher
        widens a reservation when failures shrink a reserved device)."""
        if key not in self._entries:
            raise KeyError(f"{key!r} is not queued")
        if self._reserved_by is not None and self._reserved_by != key:
            raise ValueError(
                f"{self._reserved_by!r} already holds the reservation"
            )
        self._reserved_by = key
        self._reserved_devices = frozenset(devices)
        self.reservations_made += 1
        if self._trace is not None:
            self._trace.instant(
                "scheduler",
                "gang_reserve",
                self._trace_clock(),
                args={"gang": key, "devices": sorted(self._reserved_devices)},
            )

    def release(self, key: str) -> bool:
        """Drop ``key``'s reservation if it holds one; True if it did.
        Idempotent — rejection and placement paths may both call it."""
        if self._reserved_by != key:
            return False
        self._reserved_by = None
        self._reserved_devices = frozenset()
        self.reservations_released += 1
        if self._trace is not None:
            self._trace.instant(
                "scheduler", "gang_release", self._trace_clock(), args={"gang": key}
            )
        return True

    @property
    def reserved_by(self) -> Optional[str]:
        return self._reserved_by

    def reserved_against(self, key: str, device: str) -> bool:
        """Is ``device`` reserved for a job other than ``key``? The
        dispatcher's backfill veto: singletons (and other gangs) must not
        land on a reserved device."""
        return (
            self._reserved_by is not None
            and self._reserved_by != key
            and device in self._reserved_devices
        )

    # -- pre-warm reservations (forecast autoscaling) ---------------------

    def prewarm(self, device: str, kind: str = "serve") -> bool:
        """Reserve ``device`` for jobs of ``kind`` ahead of a predicted
        ramp. Idempotent per device (re-warming updates the kind without
        recounting). Returns True if a new reservation was created."""
        fresh = device not in self._prewarmed
        self._prewarmed[device] = kind
        if fresh:
            self.prewarms_made += 1
            if self._trace is not None:
                self._trace.instant(
                    "scheduler",
                    "prewarm",
                    self._trace_clock(),
                    args={"device": device, "kind": kind},
                )
        return fresh

    def prewarm_release(self, device: str) -> bool:
        """Drop ``device``'s pre-warm reservation; True if it had one."""
        if device not in self._prewarmed:
            return False
        del self._prewarmed[device]
        self.prewarms_released += 1
        if self._trace is not None:
            self._trace.instant(
                "scheduler", "prewarm_release", self._trace_clock(), args={"device": device}
            )
        return True

    def prewarm_blocks(self, device: str, kind: str) -> bool:
        """The dispatcher's backfill veto: is ``device`` warmed for a
        different kind than ``kind``? Jobs of the warmed kind still
        place freely — that is the point of warming."""
        warmed_for = self._prewarmed.get(device)
        return warmed_for is not None and warmed_for != kind

    def is_prewarmed(self, device: str) -> bool:
        return device in self._prewarmed

    def prewarmed_kind(self, device: str) -> Optional[str]:
        """The kind ``device`` is warmed for, or None — the trace layer's
        ``veto_prewarm`` provenance names what the device was held for."""
        return self._prewarmed.get(device)

    @property
    def prewarmed_devices(self) -> FrozenSet[str]:
        return frozenset(self._prewarmed)

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries
