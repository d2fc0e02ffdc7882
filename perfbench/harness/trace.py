"""The traced window: ``torch.profiler`` over a few steps, read back from its
trace.

``profile(fn)`` runs ``fn`` under the profiler (host and device activity),
inside a ``perfbench.window`` annotation, writes the trace to a temporary
file under ``TMPDIR``, reads it and deletes it. Times are made absolute (µs)
with the trace's base time, so that traces of several processes on one card
line up. ``combine`` takes the traces of the jobs of a run: the window is
the span that every job's annotation covers, the device's busy time the
union of the device operations (kernels, copies, sets) of all jobs inside
it, and each idle gap is named by the innermost host event of any job that
covers its start.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

MARK = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


def profile(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(MARK):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return parse(data)


def parse(data: dict) -> dict:
    """{"window": (start, end), "device": [(name, start, dur)], "host": [...]}, µs."""
    base = float(data.get("baseTimeNanoseconds", 0)) / 1e3
    device, host, window = [], [], None
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]) + base, float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), ts, dur))
        elif cat in HOST_CATS:
            host.append((e.get("name", "?"), ts, dur))
            if cat == "user_annotation" and e.get("name") == MARK:
                window = (ts, ts + dur)
    return {"window": window, "device": device, "host": host}


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def combine(traces: list) -> dict:
    """busy_s, window_s, the device operations inside the window (name,
    start, dur clipped, µs) and the breakdown."""
    lo = max(t["window"][0] for t in traces)
    hi = min(t["window"][1] for t in traces)
    ops = []
    for t in traces:
        for name, ts, dur in t["device"]:
            a, b = max(ts, lo), min(ts + dur, hi)
            if b > a:
                ops.append((name, a, b - a))
    busy = _union((a, a + d) for _, a, d in ops)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    by_op = defaultdict(float)
    for name, _, dur in ops:
        by_op[name] += dur
    by_host = defaultdict(float)
    for (g0, g1), name in zip(gaps, _innermost([g0 for g0, _ in gaps], [h for t in traces for h in t["host"]])):
        by_host[name] += g1 - g0
    top = lambda d: [[n[:160], s / 1e6] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "ops": ops,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)}}


def _innermost(starts, host):
    """For each of the sorted times ``starts``, the name of the host event
    with the latest start that covers it, or ``(no host event)``."""
    host = sorted(host, key=lambda h: h[1])
    active, out, i = [], [], 0
    for t in starts:
        while i < len(host) and host[i][1] <= t:
            name, ts, dur = host[i]
            heapq.heappush(active, (-ts, ts + dur, name))
            i += 1
        while active and active[0][1] <= t:
            heapq.heappop(active)
        out.append(active[0][2] if active else "(no host event)")
    return out


def idle_share(ctx, family: str) -> float:
    """% of the traced window in which no operation ran on the card, in a
    cell of the model family ``family``; None in another."""
    if ctx["spec"]["config_data"]["model"]["family"] != family:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace"]["window_s"])
