"""Collocation characterization — the paper's §3.4 experiment matrix
(PyTorch twin of ``repro.launch.collocate``).

For every (workload x device-group) cell of the paper's grid, on the MIG tree
of the card the port runs on (``h100-80gb``), this characterizes each
instance (core/instance.py), verifies the isolation properties
(core/interference.py), and writes one JSON artifact per cell to
``artifacts/collocation/``, under the reference's file names and schema. Each
job's real train step is measured on the card once, at the suite's batch and
image size, and every cell of the job reuses that measurement: the non-MIG
solo record carries the measured step; a MIG record's step is the reference's
roofline algebra over the measured FLOPs and bytes on the instance's share of
the card (MIG instances cannot be carved without root) plus the latency the
measured step has beyond the whole card's roofline. Each cell has one key
the reference's has not, ``measured``: the record fields that came from the
device. Each workload also gets the analytic shared-mode cells
(``mode="naive"`` / ``mode="mps"`` at k = 2, 4, 7 copies) from the solo
record through the contention models of core/sharing.py, against the card's
whole memory.

``benchmarks/report.py collocate`` and ``modes`` read the artifacts.

Usage:
  python -m repro_torch.launch.collocate [--workloads resnet_small,...]
      [--out artifacts/collocation] [--device cuda] [--reduced]

``--reduced`` runs the CPU-scale configs at batch REDUCED_BATCH (a dry run:
``--device cpu --reduced``). Only the paper's trio is characterized: an LM
workload's suite (train_4k, batch 256) does not fit one card without gradient
accumulation, which is queued in ROADMAP.md.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.core import interference
from repro_torch.core.collocation import paper_experiment_grid
from repro_torch.core.device import get_sku
from repro_torch.core.instance import InstanceRecord, InstanceRuntime, JobSpec, measure_job
from repro_torch.core.metrics import (
    collocation_speedup,
    device_group_report,
    epoch_time_s,
)
from repro_torch.core.partitioner import partition
from repro_torch.core.sharing import (
    CollocationMode,
    SoloProfile,
    shared_mode_report,
)

# the MIG tree of the card the port runs on
SKU = "h100-80gb"

# collocated-copy counts for the analytic naive/MPS cells (the paper sweeps
# 2..7 concurrent models; 7 matches the max 1g MIG instance count)
SHARED_KS = (2, 4, 7)

# The paper's workloads: batch 32 everywhere (§3.4); epoch sizes from the
# datasets (CIFAR-10 45k train / ImageNet64 1.28M / ImageNet 1.28M).
PAPER_SUITES = {
    "resnet_small": (ShapeSuite("paper_small", 32 * 32, 32, "train"), 45_000),
    "resnet_medium": (ShapeSuite("paper_medium", 64 * 64, 32, "train"), 1_281_167),
    "resnet_large": (ShapeSuite("paper_large", 224 * 224, 32, "train"), 1_281_167),
}
# the batch of a --reduced run, at the reduced config's image size
REDUCED_BATCH = 4


def host_latency_s(rec) -> float:
    """The measured step less the roofline's busy time: the per-step time in
    which the model's engines are idle (host dispatch, launches, kernels
    below their roofs). ``SoloProfile.from_record`` takes it as the job's
    latency floor, so the profile's step is the measured one while its busy
    terms stay the roofline's. 0 where the roofline is slower than the step."""
    busy = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    return max(0.0, rec["step_s"] - busy)


def run_cell(workload: str, group: str, placements, device, suite, samples, out_dir, measurements):
    """One device-group cell: characterize each instance, verify isolation."""
    partitioned = group != "non-MIG"
    instances = partition(device, placements, partitioned=partitioned, sku=SKU)
    records = []
    collectives = {}
    t0 = time.time()
    for i, inst in enumerate(instances):
        rt = InstanceRuntime(inst, partitioned=partitioned, sku=SKU, measurements=measurements)
        job = JobSpec(name=f"{workload}#{i}", arch=workload, suite=suite)
        rec = rt.characterize(job)
        records.append(rec)
        collectives[inst.label] = rt.measure(job).collectives
    iso = interference.verify_isolation(instances, records, collectives)
    group_rep = device_group_report(group, workload, records, sku=SKU)
    cell = {
        "workload": workload,
        "group": group,
        "mode": "mig" if partitioned else "solo",
        "status": "OK",
        "t_wall_s": round(time.time() - t0, 1),
        "suite": suite.name,
        "samples_per_epoch": samples,
        "records": [r.to_dict() for r in records],
        "epoch_time_s": [epoch_time_s(r, samples, suite.global_batch) for r in records],
        "device_group": group_rep.to_dict(),
        "isolation": dataclasses.asdict(iso),
        "measured": list(rt.measured_fields(job)),
    }
    label = f"{workload}__{group.replace(' ', '_').replace('.', '_')}"
    (out_dir / f"{label}.json").write_text(json.dumps(cell, indent=2))
    return cell


def run_shared_cell(workload, mode, k, solo_rec, suite, samples, out_dir, measured):
    """One analytic shared-mode cell: k collocated copies of ``workload``
    under ``mode`` (naive/mps), derived from the full-card solo record
    through the contention model, its memory held to the card's whole memory
    (the solo record's budget). ``measured`` is the solo cell's list less
    the step, which the model predicts."""
    mode = CollocationMode(mode)
    solo = SoloProfile.from_record(f"{workload}#0", solo_rec, latency_s=host_latency_s(solo_rec))
    jobs = [
        dataclasses.replace(solo, name=f"{workload}#{i}") for i in range(k)
    ]
    rep = shared_mode_report(mode, jobs, hbm_budget_bytes=solo_rec["hbm_budget_bytes"])
    quant = interference.quant_from_report(rep)
    base = InstanceRecord(**solo_rec)
    records = [
        dataclasses.replace(
            base,
            job=j.name,
            mode=mode.value,
            step_s=float(rep.effective_step_s[j.name]),
            fits=rep.fits,
        )
        for j in jobs
    ]
    cell = {
        "workload": workload,
        "group": f"{mode.value} x{k}",
        "mode": mode.value,
        "status": "OK",
        "suite": suite.name,
        "samples_per_epoch": samples,
        "records": [r.to_dict() for r in records],
        "epoch_time_s": [
            epoch_time_s(r, samples, suite.global_batch) for r in records
        ],
        "solo_step_s": solo.step_s,
        "shared": rep.to_dict(),
        "interference_quant": quant.to_dict(),
        "measured": [f for f in measured if f != "step_s"],
    }
    label = f"{workload}__{mode.value}_x{k}"
    (out_dir / f"{label}.json").write_text(json.dumps(cell, indent=2))
    return cell


def main(argv=None) -> int:
    """Runs the grid; returns the exit code, 1 if any cell failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--workloads",
        default="resnet_small,resnet_medium,resnet_large",
        help="comma-separated registry keys (the paper's trio)",
    )
    ap.add_argument("--out", default="artifacts/collocation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a dry run")
    ap.add_argument("--reduced", action="store_true",
                    help=f"CPU-scale configs at batch {REDUCED_BATCH}")
    args = ap.parse_args(argv)

    workloads = args.workloads.split(",")
    others = [w for w in workloads if w not in PAPER_SUITES]
    if others:
        raise NotImplementedError(
            f"{others}: the port characterizes the paper's trio only; an LM suite "
            "needs gradient accumulation to the suite's batch (ROADMAP.md, Queue 1)"
        )
    device = resolve_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    sku = get_sku(SKU)

    results = []
    failures = 0
    measurements = {}  # (arch, suite) -> the job measured once on the device
    # isolated full-device reference for F2 speedup
    full_rec = {}
    for w in workloads:
        suite, samples = PAPER_SUITES[w]
        cfg = get_config(w)
        if args.reduced:
            cfg = cfg.reduced()
            suite = ShapeSuite(suite.name, cfg.img_size**2, REDUCED_BATCH, "train")
        try:  # once a job: every cell below reuses it
            measurements[(w, suite)] = measure_job(JobSpec(f"{w}#0", w, suite), cfg, device)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {w} measure: {e}", flush=True)
            traceback.print_exc(limit=3)
            continue
        solo_rec = None
        for w2, group, placements in paper_experiment_grid([w], suite, sku=sku):
            try:
                cell = run_cell(w, group, placements, device, suite, samples, out_dir, measurements)
                results.append(cell)
                recs = cell["records"]
                if group == f"{sku.full_profile} one":
                    full_rec[w] = recs[0]
                if group == "non-MIG":
                    solo_rec = recs[0]
                    solo_measured = cell["measured"]
                speed = ""
                if "parallel" in group and w in full_rec:
                    par = [InstanceRecord(**r) for r in recs]
                    iso_full = InstanceRecord(**full_rec[w])
                    speed = f" collocation_speedup={collocation_speedup(par, iso_full):.2f}x"
                print(
                    f"[OK]   {w:<16} {group:<18} inst={len(recs)} "
                    f"step={recs[0]['step_s']:.4f}s fits={all(r['fits'] for r in recs)}"
                    f" iso={cell['isolation']['disjoint']}" + speed,
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[FAIL] {w} {group}: {e}", flush=True)
                traceback.print_exc(limit=3)
        # analytic shared-mode cells (naive / MPS) from the solo baseline
        if solo_rec is None:
            print(f"[SKIP] {w} shared modes: no non-MIG solo record", flush=True)
            continue
        for mode in (CollocationMode.NAIVE, CollocationMode.MPS):
            for k in SHARED_KS:
                try:
                    cell = run_shared_cell(
                        w, mode, k, solo_rec, suite, samples, out_dir, solo_measured
                    )
                    results.append(cell)
                    rep = cell["shared"]
                    print(
                        f"[OK]   {w:<16} {cell['group']:<18} "
                        f"inst={k} step={cell['records'][0]['step_s']:.4f}s "
                        f"fits={rep['fits']} "
                        f"max_interf={cell['interference_quant']['max_slowdown']:.2f}x",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    print(f"[FAIL] {w} {mode.value} x{k}: {e}", flush=True)
                    traceback.print_exc(limit=3)
    summary = {
        "cells": len(results),
        "failures": failures,
    }
    (out_dir / "_summary.json").write_text(json.dumps(summary, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
