"""Host-side input pipeline with the paper's §3.3.1 knobs.

The paper tunes TensorFlow's ``ImageDataGenerator`` with two parameters —
``workers`` (CPU threads producing preprocessed batches) and
``max_queue_size`` (bounded RAM queue of ready batches) — until Tensorboard
shows near-zero input-wait. This module is the equivalent, in numpy and
threads (a copy of ``repro.data.pipeline``, which imports no framework, kept
in the port so that it imports nothing of ``repro``):

  * ``HostPipeline`` runs ``workers`` daemon threads, each materializing
    deterministic synthetic batches (data/synthetic.py) into a bounded
    queue of ``max_queue_size`` — batches are claimed by step index so the
    stream order is deterministic regardless of thread interleaving;
  * per-batch *wait time* is measured on the consumer side — the same
    "time spent on input" signal the paper minimized; ``stats()`` exposes
    it so the F7 host-side findings (n collocated jobs -> n x CPU, n x RAM)
    can be benchmarked;
  * queue memory is accounted analytically (bytes per buffered batch x
    ``max_queue_size``), reproducing the paper's RAM-vs-parallelism trade.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class HostPipeline:
    """Bounded multi-worker prefetch pipeline over a deterministic source."""

    def __init__(
        self,
        make_batch: Callable[[int], Dict[str, np.ndarray]],  # step -> batch
        *,
        workers: int = 1,
        max_queue_size: int = 10,
        start_step: int = 0,
    ):
        self.make_batch = make_batch
        self.workers = workers
        self.max_queue_size = max_queue_size
        self._q: "queue.Queue[tuple[int, dict]]" = queue.Queue(maxsize=max_queue_size)
        self._next_to_produce = start_step
        self._next_to_consume = start_step
        self._produce_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._wait_s = 0.0
        self._batches = 0
        self._stash: Dict[int, dict] = {}
        self._stash_lock = threading.Lock()

    # -- worker side ---------------------------------------------------------

    def _claim_step(self) -> int:
        with self._produce_lock:
            s = self._next_to_produce
            self._next_to_produce += 1
            return s

    def _worker(self):
        while not self._stop.is_set():
            step = self._claim_step()
            batch = self.make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self) -> "HostPipeline":
        for _ in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        # drain so blocked producers exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- consumer side ---------------------------------------------------------

    def get(self) -> Dict[str, np.ndarray]:
        """Next batch in deterministic step order; measures input-wait."""
        want = self._next_to_consume
        t0 = time.perf_counter()
        while True:
            with self._stash_lock:
                if want in self._stash:
                    batch = self._stash.pop(want)
                    break
            step, batch = self._q.get()
            if step == want:
                break
            with self._stash_lock:
                self._stash[step] = batch
        self._wait_s += time.perf_counter() - t0
        self._batches += 1
        self._next_to_consume += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.get()

    # -- accounting ----------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        return {
            "batches": float(self._batches),
            "input_wait_s": self._wait_s,
            "input_wait_per_batch_ms": (
                1e3 * self._wait_s / self._batches if self._batches else 0.0
            ),
            "workers": float(self.workers),
            "max_queue_size": float(self.max_queue_size),
        }

    @staticmethod
    def queue_bytes(batch: Dict[str, np.ndarray], max_queue_size: int) -> int:
        """RAM bound of the prefetch queue (paper's F7 memory accounting)."""
        per = sum(a.nbytes for a in batch.values())
        return per * max_queue_size
