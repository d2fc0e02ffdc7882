"""One run of one cell: set-up, the measured window, the traced window and
the check, for each of the cell's jobs, and the result the run prints.

A cell of one job runs it in this process. A cell of k jobs runs each in a
process of its own on the same card (``harness.collocate``), as users
collocate jobs without MPS: the driver time-slices their contexts.

The measured window starts once every job is warm. One job's window ends
at the end of its first step that ends ``seconds`` after the start, and its
rate is the items of all its steps over that time. k jobs share the window
[start, start + seconds] and the rate counts the items of every step of
every job that ended inside it. With ``trace`` the jobs then run a traced
window (``harness.trace``) of ``trace_steps`` steps for one job, or of
``trace_seconds`` for k. The check follows every job's first steps with
the reference after its windows, its state freed.
"""
from __future__ import annotations

import math
import time

import torch

from harness import check, collocate, feed, trace
from harness.job import Job

#: seconds between the end of the measured window and the start of the traced one, for k jobs
TRACE_LEAD_S = 0.5


def run_job(spec: dict, seed: int, seconds: float, with_trace: bool, device, gate=None) -> dict:
    """Runs one job. ``gate`` (k jobs) is called once the job is warm and
    returns the window's start on the shared clock; without it the window
    starts at once. Returns the job's record."""
    job = Job(spec, seed, device)
    readout = job.setup()
    if gate is None:
        if job.device.type == "cuda":
            torch.cuda.synchronize(job.device)
        start = time.perf_counter()
    else:
        start = gate()
        while time.perf_counter() < start:
            pass
    ends = job.run_until(start + seconds)
    traced = None
    if with_trace:
        traffic = spec["traffic_data"]
        if gate is None:
            traced = trace.profile(lambda: [job.step() for _ in range(traffic["trace_steps"])])
        else:
            lead = start + seconds + TRACE_LEAD_S
            job.run_until(lead)
            traced = trace.profile(lambda: job.run_until(lead + traffic["trace_seconds"]))
    n = spec["traffic_data"]["checked_steps"]
    window_losses = job.losses[n:n + len(ends)]
    record = {"start": start, "ends": ends, "peak_bytes": job.peak_bytes(), "trace": traced,
              "failed": sum(0 if math.isfinite(x) else 1 for x in window_losses)}
    record["numbers"] = job.check(readout)
    record["reference_s"] = job.reference_s
    return record


def run(spec: dict, seed: int, seconds: float, with_trace: bool, device="cuda", t_process=None) -> dict:
    """The run's measurements: ``rate`` (items/s), ``setup_s``,
    ``peak_bytes`` (summed over jobs), ``step_ms`` (every step of the
    window), ``steps``, ``failed``, ``numbers`` (worst over jobs), the
    combined trace, and ``jobs``."""
    t_process = time.perf_counter() if t_process is None else t_process
    k = spec["traffic_data"]["jobs"]
    if k == 1:
        records = [run_job(spec, seed, seconds, with_trace, device)]
    else:
        records = collocate.run(spec, seed, seconds, with_trace, device)
    start = records[0]["start"]
    items = feed.items_per_step(spec)
    step_ms = []
    if k == 1:
        ends = records[0]["ends"]
        steps = len(ends)
        rate = steps * items / (ends[-1] - start)
    else:
        steps = sum(sum(1 for t in r["ends"] if t <= start + seconds) for r in records)
        rate = steps * items / seconds
    for r in records:
        prev = start
        for t in r["ends"]:
            if k == 1 or t <= start + seconds:
                step_ms.append((t - prev) * 1e3)
            prev = t
    out = {
        "rate": rate, "setup_s": start - t_process, "peak_bytes": sum(r["peak_bytes"] for r in records),
        "step_ms": step_ms, "steps": steps, "jobs": k,
        "reference_s": max(r["reference_s"] for r in records),
        "failed": sum(r["failed"] for r in records),
        "numbers": check.worst([r["numbers"] for r in records]),
        "trace": trace.combine([r["trace"] for r in records]) if with_trace else None,
        "forbidden_modules": sorted({m for r in records for m in r.get("forbidden_modules", [])}),
    }
    return out

