"""Where a training step of the PyTorch/CUDA port spends its time.

Trains granite-3-2b at full size on the GPU (batch 2, seq 4096, remat on, as
``chip_smoke.py`` does) and prints:

  * wall ms per step and how much of it the host spent queueing work (when
    the two are equal the step is host-bound);
  * the step split into forward, backward and AdamW by CUDA events;
  * the same step with the layer views taken by one ``a[i]`` per layer and
    leaf instead of one ``unbind`` per leaf (``models/module.py``), in turns
    with the package's way, with the peak device memory of each;
  * a ``torch.profiler`` trace of one step: device busy and idle share, device
    time by kind of kernel (the flash kernels, library matrix products, the
    rest) and the kernels that take the most. The trace is written to
    ``artifacts/train_step_trace.json``.

    PYTHONPATH=src python examples/profile_train_torch.py
"""
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models import module
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

ARCH, BATCH, SEQ = "granite-3-2b", 2, 4096
OUT = Path(__file__).resolve().parent.parent / "artifacts"

GEMM_MARKS = ("gemm", "Gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_")


def kind(name: str) -> str:
    if name.startswith("flash_") or "flash_bwd" in name or "flash_fwd" in name:
        return "flash kernels (K1, K2, K3)"
    if any(m in name for m in GEMM_MARKS):
        return "library matrix products"
    return "other (elementwise, reductions, copies)"


def select_layers(stacked):
    """The per-layer ``a[i]`` way the package does not use."""
    n = next(tree_leaves(stacked)).shape[0]
    return [module.layer_params(stacked, i) for i in range(n)]


def main():
    device = resolve_device("cuda")
    cfg = get_config(ARCH)
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=100)
    state = ts.init_train_state(model, torch.Generator(device=device).manual_seed(0), opt, device)
    step_fn = ts.build_train_step(model, plan, opt)
    suite = ShapeSuite("train_4k", SEQ, BATCH, "train")
    batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}
    print(torch.cuda.get_device_name(device), flush=True)

    def steps(n):
        """(wall ms, host ms) per step over n steps."""
        nonlocal state
        walls, hosts = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.mean(walls)) * 1e3, float(np.mean(hosts)) * 1e3

    steps(2)  # warm-up
    wall, host = steps(3)
    print(f"step: {wall:.1f} ms wall, {host:.1f} ms host to queue it", flush=True)

    # forward / backward / optimizer by CUDA events
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = defaultdict(list)
    for _ in range(3):
        ev[0].record()
        loss, _ = model.loss(params, batch, plan)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        gtree = module.tree_unflatten(params, grads)
        params, opt_state, _ = adamw.apply_updates(params, gtree, state["opt"], opt)
        state = {"params": params, "opt": opt_state}
        ev[3].record()
        torch.cuda.synchronize()
        del grads, gtree
        for name, a, b in (("forward", 0, 1), ("backward (remat forward included)", 1, 2), ("adamw", 2, 3)):
            split[name].append(ev[a].elapsed_time(ev[b]))
    for name, ms in split.items():
        print(f"  {name}: {np.mean(ms):.1f} ms", flush=True)

    # how the layer views are taken, in turns
    package_way = module.unbind_layers
    for way in ("unbind", "select", "select", "unbind"):
        module.unbind_layers = package_way if way == "unbind" else select_layers
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wall, _ = steps(2)
        finally:
            module.unbind_layers = package_way
        print(f"layer views by {way}: {wall:.1f} ms/step, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

    # one step under the profiler
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_breakdown(prof, OUT / "train_step_trace.json", kind, f"profiled step: {wall_us / 1e3:.1f} ms wall")


def print_breakdown(prof, trace_path: Path, kind_of, label: str) -> None:
    """From a ``torch.profiler`` run over CUDA: writes its trace to
    ``trace_path`` and prints device busy time and idle share over the window
    from the first kernel to the last, device time by ``kind_of(name)``, and
    the kernels that take the most."""
    trace_path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    kernels = [e for e in events.get("traceEvents", []) if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        print("the profiler recorded no device kernels: no breakdown", flush=True)
        return
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    by_kind, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        by_kind[kind_of(e["name"])] += float(e["dur"])
        by_name[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    print(f"{label}, {len(kernels)} kernels, device busy "
          f"{busy / 1e3:.1f} ms = {busy / window:.3f} of the first-to-last-kernel window "
          f"({window / 1e3:.1f} ms); idle share {1 - busy / window:.3f}", flush=True)
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {us / 1e3:.1f} ms ({us / busy:.3f} of busy)", flush=True)
    print("top kernels by device time:", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:8.2f} ms  x{count[name]:<5d} {name[:110]}", flush=True)

if __name__ == "__main__":
    main()
