"""End-to-end training launcher (PyTorch twin of ``repro.launch.train``).

Build the model from ``--arch``, stream deterministic synthetic data through
the host pipeline, checkpoint every ``--ckpt-every`` steps (async, atomic),
resume automatically from the latest valid checkpoint, and log step time /
loss / input-wait. Runs on the GPU unless ``--device cpu`` is given; on the
CPU use ``--reduced`` for a runnable config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --reduced \\
      --steps 12 --batch 4 --seq 32 --warmup 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 6 --batch 2 --seq 4096

Prints the reference's result keys as JSON. ``--mesh host`` is refused: the
multi-device substrate is ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.data.pipeline import HostPipeline
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="LR schedule horizon (0 -> --steps); pin it when a "
                         "run will be interrupted/resumed so the schedule "
                         "is invariant to the stopping point")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--max-queue-size", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=("none", "host"), default="none",
                    help="'host' is not ported yet (ROADMAP Queue 1 item 11)")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a dry run")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train ``args.steps`` steps (minus any resumed ones); returns the result dict."""
    if args.mesh != "none":
        raise NotImplementedError(
            "--mesh host: the multi-device substrate is not ported yet (ROADMAP Queue 1 item 11)"
        )
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    suite = ShapeSuite("train_cli", args.seq, args.batch, "train")
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(
        lr_peak=args.lr, warmup_steps=args.warmup,
        total_steps=args.total_steps or max(args.steps, 1),
    )
    plan = make_plan(cfg, None)
    step_fn = ts.build_train_step(model, plan, opt_cfg, grad_accum=args.grad_accum)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = ts.init_train_state(model, gen, opt_cfg, device)
    start_step = 0

    store = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir)
        latest = store.latest_step()
        if latest is not None:
            state, extra = store.restore(state, latest)
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    pipeline = HostPipeline(
        lambda step: synthetic.batch_for(cfg, suite, seed=args.seed, step=step),
        workers=args.workers,
        max_queue_size=args.max_queue_size,
        start_step=start_step,
    ).start()

    losses = []
    step_times = []
    _sync(device)
    t_train0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in pipeline.get().items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step's work on the device
            step_times.append(time.perf_counter() - t0)
            losses.append(loss)
            if np.isnan(loss):
                raise FloatingPointError(f"NaN loss at step {step}")
            if (step + 1) % args.log_every == 0:
                print(
                    f"[train] step {step + 1}/{args.steps} loss={loss:.4f} "
                    f"step_time={np.mean(step_times[-args.log_every:]) * 1e3:.1f}ms",
                    flush=True,
                )
            if store and (step + 1) % args.ckpt_every == 0:
                store.save(step + 1, state, extra={"loss": loss}, async_save=True)
    finally:
        pipeline.stop()
    if store:
        if losses:  # a run resumed at its last step takes none and has nothing new to save
            store.save(args.steps, state, extra={"loss": losses[-1]})
        store.wait()

    _sync(device)
    wall = time.perf_counter() - t_train0
    result = {
        "arch": args.arch,
        "steps": args.steps - start_step,
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        # window means: single-step losses on stochastic batches are too
        # noisy to compare individually
        "head_mean_loss": float(np.mean(losses[:5])) if losses else None,
        "tail_mean_loss": float(np.mean(losses[-5:])) if losses else None,
        "mean_step_ms": float(np.mean(step_times[3:]) * 1e3) if len(step_times) > 3 else None,
        "wall_s": wall,
        "pipeline": pipeline.stats(),
    }
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(result, indent=2))
    return result


def main():
    args = build_argparser().parse_args()
    result = run(args)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
