"""Where one prefill of the PyTorch/CUDA port spends its device time.

Serves one prefill of rwkv6-1.6b (or ``--arch``) at the serving shape of
``chip_smoke.py`` (batch 8, prompt 2048; random weights from a seed) on the
GPU, after a warm-up prefill, under ``torch.profiler``, and prints the device
busy time and idle share, device time by kind of kernel (the port's own
kernels: K5 for rwkv6, K1 for a transformer; library matrix products; the
rest: elementwise PyTorch, reductions, copies) and the kernels that take the
most. The trace is written to ``artifacts/prefill_trace.json``.

    PYTHONPATH=src python examples/profile_prefill_torch.py [--arch rwkv6-1.6b]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from profile_train_torch import GEMM_MARKS, OUT, print_breakdown
from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.sharding.plan import make_plan

BATCH, PROMPT = 8, 2048


def kind(name: str) -> str:
    if name.startswith(("wkv6_", "flash_")) or "wkv6_kernel" in name or "flash_fwd" in name:
        return "the port's kernels (K5, K1)"
    if any(m in name for m in GEMM_MARKS):
        return "library matrix products"
    return "other (elementwise, reductions, copies)"


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    args = ap.parse_args()
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    prompts = torch.from_numpy(synthetic.token_batch(cfg.vocab, BATCH, PROMPT, seed=7)["tokens"]).to(device)
    print(torch.cuda.get_device_name(device), flush=True)
    model.prefill(params, {"tokens": prompts}, plan)  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompts}, plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_breakdown(prof, OUT / "prefill_trace.json", kind, f"profiled {args.arch} prefill: {wall_ms:.1f} ms wall")


if __name__ == "__main__":
    main()
