"""Collocation characterization — the paper's §3.4 experiment matrix
(PyTorch twin of ``repro.launch.collocate``).

For every (workload x device-group) cell of the paper's grid, on the MIG tree
of the card the port runs on (``h100-80gb``), this characterizes each
instance (core/instance.py), verifies the isolation properties
(core/interference.py), and writes one JSON artifact per cell to
``artifacts/collocation/``, under the reference's file names and schema. Each
job's real step is measured on the card once, at the suite's batch and
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

Any registry key outside the trio is an LM workload and takes the
reference's ``LM_SUITE`` (train_4k: seq 4096, global batch 256, an epoch of
1,281,167 samples), which one card reaches by gradient accumulation: micro
batches of ``LM_MICRO_BATCH``, so ``grad_accum = 256 // 2 = 128`` (the
reference's ``--lm-suite`` flag is taken and changes nothing, as there).
Before a workload is built its train state is reckoned (``state_bytes``:
parameters and gradients, the f32 accumulator, AdamW's moments) and held
against the card's whole memory (the full profile's budget): a workload whose
state alone exceeds it is skipped, printed as ``[SKIP]`` and listed under
``skipped`` in ``_summary.json``, with nothing built or allocated for it.
rwkv6-1.6b does not train on the card (its WKV6 kernel has no backward, nor
has the reference's) and counts as a failure there.

``benchmarks/report.py collocate`` and ``modes`` read the artifacts.

Usage:
  python -m repro_torch.launch.collocate [--workloads resnet_small,...]
      [--out artifacts/collocation] [--device cuda] [--reduced] [--lm-suite]

``--reduced`` runs the CPU-scale configs at batch REDUCED_BATCH (a dry run:
``--device cpu --reduced``); an LM workload's suite keeps its name at
sequence REDUCED_LM_SEQ, accumulated from micro batches of LM_MICRO_BATCH.
``characterize_workload`` is the per-workload body, for a caller that picks
its own suite (``chip_smoke.py`` drives granite-3-2b at a smaller global
batch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

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
from repro_torch.core.profiles import Placement
from repro_torch.core.sharing import (
    CollocationMode,
    SoloProfile,
    shared_mode_report,
)
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.optim.adamw import AdamWConfig

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
# LM workloads reuse the assigned shape suites (collocation is arch-agnostic),
# with an epoch of ImageNet's size, as the reference has them
LM_SUITE = ShapeSuite("train_4k", 4096, 256, "train")
LM_SAMPLES = 1_281_167
# the micro batch of an LM step: granite-3-2b's trained shape at seq 4096 under
# remat (a 34.97 GB peak on an H100, PERF.md); a step accumulates
# global_batch // LM_MICRO_BATCH of them
LM_MICRO_BATCH = 2
# the batch of a --reduced run, at the reduced config's image size or, for an
# LM workload, at sequence REDUCED_LM_SEQ
REDUCED_BATCH = 4
REDUCED_LM_SEQ = 32


def host_latency_s(rec) -> float:
    """The measured step less the roofline's busy time: the per-step time in
    which the model's engines are idle (host dispatch, launches, kernels
    below their roofs). ``SoloProfile.from_record`` takes it as the job's
    latency floor, so the profile's step is the measured one while its busy
    terms stay the roofline's. 0 where the roofline is slower than the step."""
    busy = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    return max(0.0, rec["step_s"] - busy)


def run_cell(workload: str, group: str, placements, device, suite, samples, out_dir, measurements,
             grad_accum: int = 1):
    """One device-group cell: characterize each instance, verify isolation."""
    partitioned = group != "non-MIG"
    instances = partition(device, placements, partitioned=partitioned, sku=SKU)
    records = []
    collectives = {}
    t0 = time.time()
    for i, inst in enumerate(instances):
        rt = InstanceRuntime(inst, partitioned=partitioned, sku=SKU, measurements=measurements)
        job = JobSpec(name=f"{workload}#{i}", arch=workload, suite=suite, grad_accum=grad_accum)
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


def workload_suite(workload: str, reduced: bool = False):
    """(config, suite, samples an epoch, grad_accum) of ``workload``: the
    trio's paper suite, any other key's ``LM_SUITE`` accumulated from micro
    batches of LM_MICRO_BATCH; ``reduced``, the CPU-scale config at batch
    REDUCED_BATCH (the suite's name kept, so that file labels match)."""
    suite, samples = PAPER_SUITES.get(workload, (LM_SUITE, LM_SAMPLES))
    cfg = get_config(workload)
    if reduced:
        cfg = cfg.reduced()
        seq = cfg.img_size**2 if workload in PAPER_SUITES else REDUCED_LM_SEQ
        suite = ShapeSuite(suite.name, seq, REDUCED_BATCH, "train")
    grad_accum = 1 if workload in PAPER_SUITES else suite.global_batch // LM_MICRO_BATCH
    return cfg, suite, samples, grad_accum


def state_bytes(cfg, grad_accum: int) -> int:
    """The bytes a train step of ``cfg`` holds at any batch: the parameters
    and their gradients in their types, the f32 gradient accumulator where
    ``grad_accum`` > 1, and AdamW's two moments in its ``mu_dtype``. Reckoned
    from the parameters' shapes on the meta device: nothing is allocated."""
    leaves = list(tree_leaves(build_model(cfg).init(torch.Generator(device="cpu"), "meta")))
    n = sum(p.numel() for p in leaves)
    own = sum(p.numel() * p.element_size() for p in leaves)
    mu = torch.empty((), dtype=AdamWConfig().mu_dtype, device="meta").element_size()
    return 2 * own + (4 * n if grad_accum > 1 else 0) + 2 * mu * n


def characterize_workload(workload: str, cfg, suite, samples: int, device, out_dir: Path, measurements: dict,
                          *, grad_accum: int = 1) -> dict:
    """Every cell of ``workload`` (model config ``cfg``) under ``suite``: the
    job measured once on ``device`` (``measurements`` keeps it, keyed by
    (arch, suite, grad_accum)), the paper's grid on the card's MIG tree, then
    the naive and MPS cells at k = SHARED_KS. Returns ``{"cells", "failures",
    "skipped"}``: ``skipped`` is None, or the reckoned state and the budget
    it exceeds, where nothing was built."""
    sku = get_sku(SKU)
    full = partition(device, [Placement(sku.full_profile, 0)], partitioned=False, sku=sku)[0]
    need = state_bytes(cfg, grad_accum)
    if need > full.hbm_budget_bytes:
        print(f"[SKIP] {workload}: state of {need / 2**30:.1f} GiB exceeds the card's "
              f"{full.hbm_budget_bytes / 2**30:.1f} GiB", flush=True)
        return {"cells": [], "failures": 0,
                "skipped": {"workload": workload, "state_bytes": need, "budget_bytes": full.hbm_budget_bytes}}
    results, failures = [], 0
    done = {"cells": results, "failures": 0, "skipped": None}
    key = (workload, suite, grad_accum)
    try:  # once a job: every cell below reuses it
        measurements[key] = measure_job(JobSpec(f"{workload}#0", workload, suite, grad_accum=grad_accum), cfg, device)
    except Exception as e:  # noqa: BLE001
        print(f"[FAIL] {workload} measure: {e}", flush=True)
        traceback.print_exc(limit=3)
        return dict(done, failures=1)
    solo_rec = full_rec = None
    for _, group, placements in paper_experiment_grid([workload], suite, sku=sku):
        try:
            cell = run_cell(workload, group, placements, device, suite, samples, out_dir, measurements, grad_accum)
            results.append(cell)
            recs = cell["records"]
            if group == f"{sku.full_profile} one":
                full_rec = recs[0]  # the isolated full-device reference for F2's speedup
            if group == "non-MIG":
                solo_rec = recs[0]
                solo_measured = cell["measured"]
            speed = ""
            if "parallel" in group and full_rec is not None:
                par = [InstanceRecord(**r) for r in recs]
                speed = f" collocation_speedup={collocation_speedup(par, InstanceRecord(**full_rec)):.2f}x"
            print(
                f"[OK]   {workload:<16} {group:<18} inst={len(recs)} "
                f"step={recs[0]['step_s']:.4f}s fits={all(r['fits'] for r in recs)}"
                f" iso={cell['isolation']['disjoint']}" + speed,
                flush=True,
            )
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {workload} {group}: {e}", flush=True)
            traceback.print_exc(limit=3)
    # analytic shared-mode cells (naive / MPS) from the solo baseline
    if solo_rec is None:
        print(f"[SKIP] {workload} shared modes: no non-MIG solo record", flush=True)
        return dict(done, failures=failures)
    for mode in (CollocationMode.NAIVE, CollocationMode.MPS):
        for k in SHARED_KS:
            try:
                cell = run_shared_cell(workload, mode, k, solo_rec, suite, samples, out_dir, solo_measured)
                results.append(cell)
                rep = cell["shared"]
                print(
                    f"[OK]   {workload:<16} {cell['group']:<18} "
                    f"inst={k} step={cell['records'][0]['step_s']:.4f}s "
                    f"fits={rep['fits']} "
                    f"max_interf={cell['interference_quant']['max_slowdown']:.2f}x",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[FAIL] {workload} {mode.value} x{k}: {e}", flush=True)
                traceback.print_exc(limit=3)
    return dict(done, failures=failures)


def main(argv=None) -> int:
    """Runs the grid; returns the exit code, 1 if any cell failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--workloads",
        default="resnet_small,resnet_medium,resnet_large",
        help="comma-separated registry keys",
    )
    ap.add_argument("--out", default="artifacts/collocation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a dry run")
    ap.add_argument("--reduced", action="store_true",
                    help=f"CPU-scale configs at batch {REDUCED_BATCH}")
    ap.add_argument("--lm-suite", action="store_true",
                    help="use train_4k for non-resnet workloads (the reference's flag: they take it anyway)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    results, skipped = [], []
    failures = 0
    measurements = {}  # (arch, suite, grad_accum) -> the job measured once on the device
    for w in args.workloads.split(","):
        cfg, suite, samples, grad_accum = workload_suite(w, args.reduced)
        done = characterize_workload(w, cfg, suite, samples, device, out_dir, measurements, grad_accum=grad_accum)
        results += done["cells"]
        failures += done["failures"]
        if done["skipped"] is not None:
            skipped.append(done["skipped"])
    summary = {
        "cells": len(results),
        "failures": failures,
    }
    if skipped:
        summary["skipped"] = skipped
    (out_dir / "_summary.json").write_text(json.dumps(summary, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
