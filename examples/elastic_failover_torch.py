"""Elastic failover, live, PyTorch/CUDA port: a memory unit dies mid-training;
the controller kills the affected instances, repacks their jobs onto
surviving units, and the jobs RESUME FROM CHECKPOINT on another instance,
while untouched neighbours keep training without interruption (the paper's
isolation guarantee doing real work). The twin of
``examples/elastic_failover.py``.

On one card every instance is a span of the same device's memory units, so
"another instance" is another span of that card; each job runs the
single-device step (``runtime.train_step.build_train_step``), the reference's
sub-mesh collapsing to 1 x 1. Checkpoints go to a temporary directory that
is removed at the end.

Seeds: the reference seeds a job with ``hash(name) % 1000``, which changes
from process to process with ``PYTHONHASHSEED``; the twin uses ``job_seed``,
a crc32 of the name, so that a run is repeatable. ``train_steps`` keeps the
reference's signature: its callers pass the seed.

On the GPU: granite-3-2b at full width and depth 2, seq 1024, batch 4, on
``h100-80gb`` (the CUDA kernels are compiled with nvcc at first use):

    PYTHONPATH=src python examples/elastic_failover_torch.py

Dry run on the CPU with the reference's reduced config, seq 32:

    PYTHONPATH=src python examples/elastic_failover_torch.py --device cpu --reduced
"""
import argparse
import dataclasses
import sys
import tempfile
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.core.collocation import CollocationScheduler
from repro_torch.core.device import get_sku
from repro_torch.core.elastic import ElasticController
from repro_torch.core.instance import JobSpec
from repro_torch.core.partitioner import partition
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

STEPS_BEFORE, STEPS_AFTER = 4, 4
N_JOBS = 3
# on the card: granite-3-2b at full width, LAYERS deep, SEQ x BATCH tokens a
# step; the MIG tree of SKU
ARCH, LAYERS, SEQ, BATCH, SKU = "granite-3-2b", 2, 1024, 4, "h100-80gb"


def failover_config(*, reduced: bool = False):
    """granite-3-2b (its reduced config with ``reduced``), LAYERS deep, width kept."""
    cfg = get_config(ARCH)
    if reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=LAYERS)


def job_seed(name: str) -> int:
    """A job's seed: stable across processes, unlike ``hash``."""
    return zlib.crc32(name.encode()) % 1000


def make_scheduler(cfg, suite: ShapeSuite, sku) -> CollocationScheduler:
    """A scheduler over a tiny char DB in which every profile of ``sku`` fits."""
    db = {
        (cfg.name, suite.name, p.name): {"fits": True, "step_s": 0.1, "peak_bytes_per_device": 0}
        for p in get_sku(sku).profiles
    }
    return CollocationScheduler(db, sku=sku)


def train_steps(inst, cfg, suite, store, job_name, n_steps, seed=0):
    """Run n steps on an instance, resuming from the store if possible."""
    device = inst.device
    model = build_model(cfg)
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=STEPS_BEFORE + STEPS_AFTER)
    step = ts.build_train_step(model, make_plan(cfg, None), opt)
    state = ts.init_train_state(model, torch.Generator(device=device).manual_seed(seed), opt, device)
    start = 0
    latest = store.latest_step()
    if latest is not None:
        state, _ = store.restore(state, latest)  # each leaf onto the device of the fresh state's
        start = latest
        print(f"  [{job_name}] resumed from step {latest} on {inst.label}")
    losses = []
    for i in range(start, start + n_steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in synthetic.batch_for(cfg, suite, seed=seed, step=i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    store.save(start + n_steps, state)
    return losses


def instance_of(device, placement, sku):
    """The instance a placement makes of ``device``."""
    return partition(device, [placement], sku=sku)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config, seq 32")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = failover_config(reduced=args.reduced)
    suite = ShapeSuite("ft", 32 if args.reduced else SEQ, BATCH, "train")

    sched = make_scheduler(cfg, suite, SKU)
    jobs = [JobSpec(f"job{i}", cfg.name, suite) for i in range(N_JOBS)]
    schedule = sched.schedule(jobs)
    print("initial schedule:")
    for a in schedule.assignments:
        print(f"  {a.job.name} -> {a.profile}@{a.placement.start}")

    traces = {}
    with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
        stores = {j.name: CheckpointStore(Path(tmp) / j.name) for j in jobs}

        # phase 1: everyone trains and checkpoints
        for a in schedule.assignments:
            traces[a.job.name] = train_steps(
                instance_of(device, a.placement, SKU), cfg, suite, stores[a.job.name], a.job.name,
                STEPS_BEFORE, seed=job_seed(a.job.name),
            )
        print(f"phase 1 done: {STEPS_BEFORE} steps each, checkpoints written")

        # phase 2: memory unit 0 fails -> repack
        ctrl = ElasticController(sched)
        ctrl.mark_failed([0])
        event = ctrl.repack(schedule)
        print(f"\nunit 0 FAILED: killed={list(event.killed_jobs)} "
              f"survivors={list(event.survivors)}")
        print("repacked schedule:")
        for a in event.new_schedule.assignments:
            print(f"  {a.job.name} -> {a.profile}@{a.placement.start}")

        # phase 3: everyone continues; killed jobs resume from their checkpoint
        # on ANOTHER instance; survivors were never interrupted
        for a in event.new_schedule.assignments:
            traces[a.job.name] += train_steps(
                instance_of(device, a.placement, SKU), cfg, suite, stores[a.job.name], a.job.name,
                STEPS_AFTER, seed=job_seed(a.job.name),
            )

    print("\nloss traces (8 contiguous steps each: no resets, no divergence):")
    for name, tr in sorted(traces.items()):
        print(f"  {name}: " + " ".join(f"{v:.3f}" for v in tr))
        if len(tr) != STEPS_BEFORE + STEPS_AFTER:
            raise RuntimeError(f"{name} trained {len(tr)} steps, not {STEPS_BEFORE + STEPS_AFTER}")
    return {"config": cfg, "suite": suite, "schedule": schedule, "event": event, "traces": traces}


if __name__ == "__main__":
    main()
