"""The paper's headline use case, live, PyTorch/CUDA port: a hyperparameter
sweep collocated on MIG-style instances of one card. The twin of
``examples/collocated_hparam_sweep.py``.

Seven learning-rate variants of the same model train IN PARALLEL (python
threads) on seven disjoint 1-unit instances of an 8-unit card: the paper's
7 x 1g experiment, on an H100's ``1g.10gb`` instances. The scheduler admits
and packs the jobs, the partitioner binds each placement to its memory units
of the card, and the per-job losses show isolation: each job's loss trace is
the one it gives when it runs alone (F3).

On one card an instance is one device, so the reference's sub-mesh collapses
to 1 x 1 and each job runs the single-device step
(``runtime.train_step.build_train_step``), not ``jit_train_step``: a DTensor
step at world 1 only adds the cost of its wrapping, and threads sharing one
NCCL group is not what the reference does. Each thread does all of its work
(model, train state from a ``torch.Generator`` of its own, batches, steps) on
a CUDA stream of its own, so that no tensor crosses streams and the jobs'
kernels may run side by side. The port carves no real MIG instance (that
needs root and ``nvidia-smi -mig``): the instances share the card's SMs and
its memory, and each job's peak is read beside its instance's budget.

The script first runs the seven jobs one after another (the solo pass), then
all seven in their threads (the collocated pass), and raises unless every
job's two traces are equal. It prints the schedule, the walls of both passes
and their ratio (the aggregate speedup of collocation), each job's solo peak
beside its instance's budget, the collocated pass's device peak, each job's
loss trace and the winner.

On the GPU: granite-3-2b at full width and depth 2, seq 1024, batch 4, on
``h100-80gb``'s seven ``1g.10gb`` instances (the CUDA kernels are compiled
with nvcc at first use):

    PYTHONPATH=src python examples/collocated_hparam_sweep_torch.py

Dry run on the CPU with the reference's reduced config, seq 32:

    PYTHONPATH=src python examples/collocated_hparam_sweep_torch.py --device cpu --reduced
"""
import argparse
import contextlib
import dataclasses
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.core.collocation import CollocationScheduler
from repro_torch.core.device import get_sku
from repro_torch.core.instance import JobSpec
from repro_torch.core.partitioner import partition, verify_disjoint
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

STEPS = 8
LRS = [3e-4 * (2**i) for i in range(-3, 4)]  # 7 variants
# on the card: granite-3-2b at full width, LAYERS deep (the whole model's
# train state is beyond a 1g.10gb instance's budget), at SEQ x BATCH tokens a
# step, so that each step gives the card the work such an instance would;
# the MIG tree of SKU
ARCH, LAYERS, SEQ, BATCH, SKU = "granite-3-2b", 2, 1024, 4, "h100-80gb"


def sweep_config(*, reduced: bool = False):
    """granite-3-2b (its reduced config with ``reduced``), LAYERS deep, width kept."""
    cfg = get_config(ARCH)
    if reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=LAYERS)


def make_schedule(cfg, suite: ShapeSuite, lrs, sku):
    """Admission and packing of one job a learning rate through a tiny char
    DB in which every profile of ``sku`` fits; returns (jobs, schedule)."""
    db = {
        (cfg.name, suite.name, p.name): {"fits": True, "step_s": 0.1, "peak_bytes_per_device": 0}
        for p in get_sku(sku).profiles
    }
    sched = CollocationScheduler(db, sku=sku)
    jobs = [JobSpec(f"lr={lr:.1e}", cfg.name, suite) for lr in lrs]
    schedule = sched.schedule(jobs)
    if len(schedule.assignments) != len(jobs) or schedule.rejections:
        raise RuntimeError(f"the sweep did not fit the card: {schedule.rejections}")
    return jobs, schedule


def on_stream(device: torch.device):
    """A CUDA stream of its own as the current stream on the card; nothing on the CPU."""
    return torch.cuda.stream(torch.cuda.Stream(device)) if device.type == "cuda" else contextlib.nullcontext()


def run_job(inst, cfg, suite: ShapeSuite, lr: float, steps: int = STEPS) -> list:
    """``steps`` steps of one job on its instance; returns its losses."""
    device = inst.device
    with on_stream(device):
        model = build_model(cfg)
        opt = adamw.AdamWConfig(lr_peak=lr, warmup_steps=2, total_steps=steps)
        step = ts.build_train_step(model, make_plan(cfg, None), opt)
        state = ts.init_train_state(model, torch.Generator(device=device).manual_seed(0), opt, device)
        losses = []
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in synthetic.batch_for(cfg, suite, seed=0, step=i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))  # waits for this stream's work only
    return losses


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(instances, cfg, suite: ShapeSuite, lrs, names, steps: int, *, threaded: bool) -> dict:
    """Every job once: one after another, or each in a thread of its own.

    Returns {"traces": {name: losses}, "wall_s", "job_wall_s": {name: s} (from
    the job's start to its end), "peaks": {name: bytes} (the
    solo pass: each job's peak above what was allocated before it; None on
    the CPU), "device_peak" (the pass's peak above what was allocated before
    it, the largest job's in the solo pass; None on the CPU)}.
    """
    device = instances[0].device
    cuda = device.type == "cuda"
    traces, peaks, walls, errors = {}, {}, {}, {}

    def job(inst, lr, name):
        t0 = time.perf_counter()
        try:
            traces[name] = run_job(inst, cfg, suite, lr, steps)
        except BaseException as e:  # re-raised by the caller after the join
            errors[name] = e
        walls[name] = time.perf_counter() - t0

    _sync(device)
    base = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if threaded:
        threads = [threading.Thread(target=job, args=(inst, lr, name), name=name)
                   for inst, lr, name in zip(instances, lrs, names)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for inst, lr, name in zip(instances, lrs, names):
            before = torch.cuda.memory_allocated(device) if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            job(inst, lr, name)
            peaks[name] = torch.cuda.max_memory_allocated(device) - before if cuda else None
            if name in errors:
                break
    _sync(device)
    wall = time.perf_counter() - t0
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"job {name} failed") from err
    if not cuda:
        device_peak = None
    elif threaded:
        device_peak = torch.cuda.max_memory_allocated(device) - base
    else:
        device_peak = max(peaks.values())
    return {"traces": traces, "wall_s": wall, "job_wall_s": walls, "peaks": peaks, "device_peak": device_peak}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config, seq 32")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = sweep_config(reduced=args.reduced)
    suite = ShapeSuite("sweep", 32 if args.reduced else SEQ, BATCH, "train")

    # --- schedule: one job a learning rate (admission via a tiny char DB)
    jobs, schedule = make_schedule(cfg, suite, LRS, SKU)
    print("schedule:")
    for a in schedule.assignments:
        print(f"  {a.job.name:<12} -> {a.profile}@{a.placement.start}")

    # --- bind each placement to its memory units of the card
    instances = partition(device, [a.placement for a in schedule.assignments], sku=SKU)
    verify_disjoint(instances)
    names = [a.job.name for a in schedule.assignments]
    lr_of = {j.name: lr for j, lr in zip(jobs, LRS)}
    lrs = [lr_of[n] for n in names]

    # --- each job alone, then all of them at once, one thread per instance
    solo = run_pass(instances, cfg, suite, lrs, names, STEPS, threaded=False)
    par = run_pass(instances, cfg, suite, lrs, names, STEPS, threaded=True)
    diverged = [n for n in names if par["traces"][n] != solo["traces"][n]]
    if diverged:
        raise RuntimeError(f"jobs {diverged} diverged under collocation")

    n = len(names)
    print(f"\n{n} models trained one after another in {solo['wall_s']:.1f}s wall, "
          f"in parallel in {par['wall_s']:.1f}s ({solo['wall_s'] / par['wall_s']:.2f}x) "
          f"({STEPS} steps each, same data, different lr):")
    for inst, name in zip(instances, names):
        if solo["peaks"][name] is not None:
            print(f"  {name:<12} solo peak {solo['peaks'][name] / 2**30:.2f} GiB of "
                  f"{inst.label}'s {inst.hbm_budget_bytes / 2**30:.2f} GiB")
    if par["device_peak"] is not None:
        print(f"  collocated device peak {par['device_peak'] / 2**30:.2f} GiB")
    best = min(names, key=lambda k: par["traces"][k][-1])
    for name in sorted(names):
        tag = "  <-- winner" if name == best else ""
        trace = " ".join(f"{v:.4f}" for v in par["traces"][name])
        print(f"  {name:<12} losses {trace}  final {par['traces'][name][-1]:.4f}{tag}")
    return {"config": cfg, "suite": suite, "schedule": schedule, "instances": instances,
            "solo": solo, "par": par, "speedup": solo["wall_s"] / par["wall_s"], "winner": best}


if __name__ == "__main__":
    main()
