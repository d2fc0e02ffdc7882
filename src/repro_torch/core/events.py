"""Discrete-event machinery for the cluster simulator.

The cluster (core/cluster.py) is a state machine driven by a time-ordered
event heap. Everything that changes cluster state is an event:

  ARRIVAL        a job enters the admission queue (``Cluster.submit``);
  COMPLETION     a placed job finishes its remaining steps — scheduled from
                 the job's predicted step time, re-scheduled whenever the
                 device's contention changes, invalidated by a token bump;
  RECONFIG_DONE  a device finishes a mode migration (MIG re-partitioning /
                 MPS daemon restart) and rejoins the fleet;
  FAILURE        slice units on a device go unhealthy (elastic repack);
  REPAIR         failed units return to health (elastic scale-up);
  PHASE_TRANSITION  a placed job crosses a phase boundary of its workload
                 plan (core/workload.py) — its demand vector changes, so
                 shared devices re-time every neighbour and the adaptive
                 policy gets a chance to reconsider the partitioning.
                 Token-invalidated exactly like COMPLETION.
  GANG_RESERVE   a queued gang (core/gang/) has waited out the cluster's
                 starvation bound without placing; the handler grants it
                 the admission queue's device reservation so backfilling
                 singletons stop refilling the capacity it needs. Fired
                 only for gang jobs, so traces without gangs never see it.
  FORECAST_TICK  the forecast policy's clock (core/forecast/): on a fixed
                 grid of ``tick_s`` the cluster refreshes its arrival-rate
                 forecast and autoscales the warm decode-capable device
                 set. Scheduled lazily (ensured on arrival, re-armed while
                 the cluster is live), and only under policy="forecast",
                 so every other policy's event stream is untouched.

Determinism contract: events at equal times are processed in push order
(``seq`` breaks ties), so a run is a pure function of the submitted trace —
the property tests/test_cluster.py pins down to byte-identical artifacts.

Completion events are *lazy-invalidated*: rather than surgically removing a
stale event from the heap (O(n)), every job carries a generation token and
a completion event stores the token it was scheduled under; a popped event
whose token no longer matches the job's is dropped. This is the standard
discrete-event idiom for processor-sharing queues, where every arrival and
departure on a shared device re-times every neighbour.

Lazy invalidation leaks: on a re-timing-heavy trace (a shared device with k
neighbours re-prices all k on every arrival/departure/phase event) the heap
fills with dead events that are only reclaimed when their time comes up.
``tombstone`` marks an event dead at invalidation time so it is skipped in
O(log n) on the way out, and the queue compacts (rebuild + heapify) whenever
tombstones exceed half the heap — bounding the heap at ~2x the live event
count instead of the total number of re-timings. ``max_time_pushed`` records
the latest time ever scheduled, tombstoned or not: the old eager-pop drain
advanced the simulation clock over stale events too, and the cluster's
report keeps that horizon semantics without paying for the pops
(tests/test_events.py pins all of this).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Any, List, Optional, Set, Tuple


class EventKind(str, enum.Enum):
    ARRIVAL = "arrival"
    COMPLETION = "completion"
    RECONFIG_DONE = "reconfig_done"
    FAILURE = "failure"
    REPAIR = "repair"
    PHASE_TRANSITION = "phase_transition"
    GANG_RESERVE = "gang_reserve"
    FORECAST_TICK = "forecast_tick"


@dataclasses.dataclass(frozen=True)
class Event:
    time_s: float
    seq: int  # tie-break: equal-time events fire in push order
    kind: EventKind
    payload: Tuple[Any, ...] = ()

    def sort_key(self) -> Tuple[float, int]:
        return (self.time_s, self.seq)


class EventQueue:
    """Min-heap of events ordered by (time, push sequence), with lazy
    deletion: ``tombstone``-marked events are skipped on pop/peek and
    physically reclaimed when they reach the top or when a compaction
    rebuilds the heap. ``len``/``bool`` count *live* events only."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        self._tombstoned: Set[int] = set()
        #: latest time ever scheduled (including later-tombstoned events) —
        #: the horizon the old eager-pop drain would have advanced the
        #: clock to; float("-inf") until the first push.
        self.max_time_pushed = float("-inf")
        #: number of heap rebuilds triggered by the tombstone threshold.
        self.compactions = 0
        #: total events ever tombstoned — with ``compactions`` this tells
        #: how much of a run's event traffic was re-timing churn.
        self.tombstones = 0
        #: largest physical heap length ever reached (live + dead), the
        #: memory high-water mark the compaction policy is bounding.
        self.peak_heap_len = 0

    def push(self, time_s: float, kind: EventKind, payload: Tuple[Any, ...] = ()) -> Event:
        ev = Event(float(time_s), self._seq, EventKind(kind), tuple(payload))
        heapq.heappush(self._heap, (ev.time_s, ev.seq, ev))
        self._seq += 1
        if len(self._heap) > self.peak_heap_len:
            self.peak_heap_len = len(self._heap)
        if ev.time_s > self.max_time_pushed:
            self.max_time_pushed = ev.time_s
        return ev

    def tombstone(self, ev: Event) -> bool:
        """Mark a still-queued event dead; it will never be returned by
        ``pop``. The caller must only tombstone events it pushed and has
        not yet popped (the cluster tracks one pending event per job).
        Returns False if the event was already tombstoned."""
        if ev.seq in self._tombstoned:
            return False
        self._tombstoned.add(ev.seq)
        self.tombstones += 1
        # reclaim space before dead weight dominates: compacting at the
        # half-full mark keeps the heap O(live) while amortizing the
        # rebuild over at least len(heap)/2 tombstone calls
        if len(self._tombstoned) * 2 > len(self._heap):
            self.compact()
        return True

    def compact(self) -> None:
        """Physically drop every tombstoned event and re-heapify."""
        if not self._tombstoned:
            return
        self._heap = [item for item in self._heap if item[1] not in self._tombstoned]
        heapq.heapify(self._heap)
        self._tombstoned.clear()
        self.compactions += 1

    def pop(self) -> Event:
        while self._heap:
            _, seq, ev = heapq.heappop(self._heap)
            if seq in self._tombstoned:
                self._tombstoned.discard(seq)
                continue
            return ev
        raise IndexError("pop from empty EventQueue")

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][1] in self._tombstoned:
            self._tombstoned.discard(heapq.heappop(self._heap)[1])
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap) - len(self._tombstoned)

    def __bool__(self) -> bool:
        return len(self._heap) > len(self._tombstoned)
