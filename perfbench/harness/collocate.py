"""k jobs of a cell as k processes on one card (naive collocation).

The pattern of the program's own collocation probe, frozen here: each job
is a child process (``perfbench/job.py``, started with ``subprocess``) that
builds its job, runs its set-up and prints ``ready``; once all are ready
the parent writes the window's start time, a little ahead, to a start file
in a temporary directory under ``TMPDIR``, and every child waits for that
instant on the shared monotonic clock (``time.perf_counter``). Each child
reports its step count and peak on a line of its own (``perfbench-job
{...}``) and leaves its whole record, with its trace, in a file beside the
start file. Any failure kills every child that is still running.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from harness.spec import BENCH_DIR

READY_TIMEOUT_S = 300
#: the window starts this long after the last job is ready
START_AHEAD_S = 0.25
DONE = "perfbench-job "


def _read(proc, lines: list) -> None:
    for line in proc.stdout:
        lines.append(line)
        sys.stderr.write(line)


def run(spec: dict, seed: int, seconds: float, with_trace: bool, device) -> list:
    k = spec["traffic_data"]["jobs"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs, readers = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        start_file = Path(tmp) / "start"
        try:
            for i in range(k):
                args = {"spec": spec, "seed": seed + i, "seconds": seconds, "trace": with_trace,
                        "device": str(device), "start_file": str(start_file), "record": f"{tmp}/job{i}.json"}
                proc = subprocess.Popen([sys.executable, str(BENCH_DIR / "job.py"), json.dumps(args)],
                                        stdout=subprocess.PIPE, text=True, env=env)
                procs.append(proc)
                logs.append([])
                readers.append(threading.Thread(target=_read, args=(proc, logs[-1]), daemon=True))
                readers[-1].start()
            t0 = time.perf_counter()
            while not all("ready\n" in log for log in logs):
                if any(p.poll() is not None for p in procs) or time.perf_counter() - t0 > READY_TIMEOUT_S:
                    raise RuntimeError(f"a job ended or stalled before its set-up finished: exit codes "
                                       f"{[p.poll() for p in procs]}")
                time.sleep(0.01)
            part = start_file.with_suffix(".part")
            part.write_text(repr(time.perf_counter() + START_AHEAD_S))
            os.replace(part, start_file)
            codes = [p.wait(timeout=seconds + READY_TIMEOUT_S) for p in procs]
            for t in readers:
                t.join(timeout=30)
            if any(codes):
                raise RuntimeError(f"jobs exited with codes {codes}")
            records = []
            for i, log in enumerate(logs):
                if not any(line.startswith(DONE) for line in log):
                    raise RuntimeError(f"job {i} reported no result")
                records.append(json.loads(Path(f"{tmp}/job{i}.json").read_text()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return records
