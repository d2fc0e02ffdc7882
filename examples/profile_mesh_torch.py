"""Where the sharded steps of the PyTorch/CUDA port spend their time at world 1.

Starts an NCCL process group of one rank on card 0 (a ``FileStore``, as
``chip_smoke.py``'s ``phase_mesh`` does), builds a 1 x 1 (data, model) mesh,
and for granite-3-2b at full size runs, each beside its single-device twin:

  * the training step (batch 2, seq 4096, remat on): ``build_train_step``
    against ``jit_train_step(variant=...)`` for each of ``--variants``;
  * one decode step at the serving shape (batch 8, prompt 2048):
    ``model.decode`` against ``jit_decode_step(variant="baseline")``.

For each it prints and writes to ``--out`` (JSON):

  * unprofiled, the median over ``--steps`` of the wall time (call to the end
    of its device work) and of the host time to queue it (call to return):
    when the two are equal the host bounds the step;
  * one step under ``torch.profiler``: the device's busy time (the union of
    kernels, copies and sets) and idle share over the step's wall time, the
    host ops and kernel launches it dispatched, and the device's count and
    time by kind (NCCL, memcpy/memset, copy kernels, the flash kernels,
    library matrix products, the rest). The sharded step's rows less the
    single device's are what the redistributions add.

    PYTHONPATH=src python examples/profile_mesh_torch.py --out chiprun_out/mesh_profile.json
"""
import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch
import torch.distributed as tdist

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import serve_step
from repro_torch.runtime import train_step as ts
from repro_torch.runtime.serve_step import pad_cache
from repro_torch.sharding import dist
from repro_torch.sharding.plan import make_plan

ARCH, TRAIN_BATCH, TRAIN_SEQ = "granite-3-2b", 2, 4096
SERVE_BATCH, PROMPT = 8, 2048
GEMM_MARKS = ("gemm", "Gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_")


def kind(event: dict) -> str:
    name, cat = event["name"], event.get("cat")
    if cat == "gpu_memcpy":
        return "memcpy"
    if cat == "gpu_memset":
        return "memset"
    if "nccl" in name.lower():
        return "nccl"
    if "flash_" in name:
        return "flash kernels"
    if any(m in name for m in GEMM_MARKS):
        return "library matrix products"
    if "copy" in name.lower() or "Copy" in name:
        return "copy kernels"
    return "other"


def timed(fn, n: int) -> dict:
    """Medians over ``n`` calls of the wall ms and the host ms to queue."""
    walls, hosts = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"wall_ms": statistics.median(walls), "host_queue_ms": statistics.median(hosts),
            "wall_ms_runs": walls, "host_queue_ms_runs": hosts}


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "trace.json")
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kind = defaultdict(lambda: {"count": 0, "ms": 0.0})
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        rec = by_kind[kind(e)]
        rec["count"] += 1
        rec["ms"] += float(e["dur"]) / 1e3
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e["dur"]) / 1e3
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1 - busy / wall_us) if device else None,
        "device_events": len(device),
        "host_ops": sum(1 for e in events if e.get("cat") == "cpu_op"),
        "kernel_launches": sum(1 for e in runtime if "LaunchKernel" in e.get("name", "")),
        "by_kind": dict(by_kind),
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms}
                        for n, (c, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]],
    }


def measure(label: str, fn, steps: int, out: dict) -> None:
    fn()  # warm-up: DTensor caches its sharding rules at first use
    rec = dict(timed(fn, steps), **profiled(fn))
    out[label] = rec
    print(f"{label}: wall {rec['wall_ms']:.2f} ms, host queue {rec['host_queue_ms']:.2f} ms; profiled "
          f"{rec['profiled_wall_ms']:.2f} ms, device busy {rec['device_busy_ms']:.2f} ms, idle share "
          f"{rec['device_idle_share']}, {rec['host_ops']} host ops, {rec['kernel_launches']} launches", flush=True)
    for k, v in sorted(rec["by_kind"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {k}: {v['count']} events, {v['ms']:.2f} ms", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="baseline", help="comma-separated train variants to profile")
    ap.add_argument("--steps", type=int, default=3, help="unprofiled calls timed for each median")
    ap.add_argument("--out", default="artifacts/mesh_profile.json")
    args = ap.parse_args()
    device = resolve_device("cuda:0")  # an index: NCCL binds the group to it
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    out = {"card": card[0] if card else torch.cuda.get_device_name(device), "arch": ARCH,
           "torch": torch.__version__, "train": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ},
           "serve": {"batch": SERVE_BATCH, "prompt": PROMPT}, "runs": {}}
    print(out["card"], flush=True)
    cfg = get_config(ARCH)
    model = build_model(cfg)
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=100)
    suite = ShapeSuite("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}
    init = lambda: ts.init_train_state(model, torch.Generator(device=device).manual_seed(0), opt, device)  # noqa: E731
    runs = out["runs"]
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", store=tdist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1,
                                 device_id=device)
        try:
            mesh = make_mesh_shape((1, 1), ("data", "model"), device="cuda")
            out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))

            state = {"s": init()}
            single = ts.build_train_step(model, make_plan(cfg, None), opt)
            measure("train single", lambda: state.update(s=single(state["s"], batch)[0]), args.steps, runs)
            for variant in args.variants.split(","):
                del state["s"]
                torch.cuda.empty_cache()
                step, st_sh, b_sh, _ = ts.jit_train_step(model, mesh, suite, opt, variant=variant)
                state["s"], placed = dist.distribute(init(), st_sh), dist.distribute(batch, b_sh)
                measure(f"train {variant}", lambda: state.update(s=step(state["s"], placed)[0]), args.steps, runs)
                del step, placed
            del state["s"]
            torch.cuda.empty_cache()

            params = model.init(torch.Generator(device=device).manual_seed(1), device)
            toks = torch.from_numpy(synthetic.token_batch(cfg.vocab, SERVE_BATCH, PROMPT, seed=5)["tokens"]).to(device)
            plan0 = make_plan(cfg, None)
            with torch.no_grad():
                last, cache = model.prefill(params, {"tokens": toks}, plan0)
                cache = pad_cache(cache, 1)
                tok = torch.argmax(last, -1).to(torch.int32)
                measure("decode single", lambda: model.decode(params, {"token": tok}, cache, PROMPT, plan0),
                        args.steps, runs)
            dstep, p_sh, tok_sh, c_sh, _ = serve_step.jit_decode_step(
                model, mesh, ShapeSuite("d", PROMPT + 1, SERVE_BATCH, "decode"), variant="baseline")
            dargs = (dist.distribute(params, p_sh), dist.distribute({"token": tok}, tok_sh),
                     dist.distribute({k: v.clone() for k, v in cache.items()}, c_sh))
            measure("decode baseline", lambda: dstep(*dargs), args.steps, runs)
        finally:
            tdist.destroy_process_group()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
