"""Where a decode step of the PyTorch/CUDA port spends its time.

Runs granite-3-2b at full size on the GPU against a KV cache of 2048 + 32
slots, batch 8, and prints, for the kernel path and the non-kernel PyTorch
path in turns: wall ms per decode step and how much of it the host spent
queueing work (when the two are equal the step is host-bound); the host cost
of one call of the decode-attention wrapper; and a cProfile of five steps.

    PYTHONPATH=src python examples/profile_decode_torch.py
"""
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention, transformer
from repro_torch.models.model_api import build_model
from repro_torch.models.transformer import init_cache
from repro_torch.sharding.plan import make_plan

ARCH, BATCH, PROMPT, NEW = "granite-3-2b", 8, 2048, 32


@torch.no_grad()
def main():
    device = resolve_device("cuda")
    cfg = get_config(ARCH)
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device)
    tok = torch.zeros(BATCH, dtype=torch.int32, device=device)
    print(torch.cuda.get_device_name(device))

    def steps(n):
        """(wall ms, host ms) per step over n steps."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            model.decode(params, {"token": tok}, cache, PROMPT + i, plan)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, host / n * 1e3

    steps(3)  # warm-up
    kernel_decode = transformer.decode_attention
    for path in ("kernel", "torch", "torch", "kernel", "kernel", "torch"):
        # the package has no switch: rebind the name the transformer calls
        if path == "torch":
            transformer.decode_attention = attention.torch_decode_attention
        try:
            wall, host = steps(10)
        finally:
            transformer.decode_attention = kernel_decode
        print(f"{path:6s} path: {wall:7.2f} ms/step wall, {host:7.2f} ms/step host")

    q = torch.randn(BATCH, cfg.n_heads, cfg.resolved_head_dim, device=device).bfloat16()
    kv_len = torch.tensor([PROMPT + 12], dtype=torch.int32, device=device)
    kc, vc = cache["k"][0], cache["v"][0]
    n = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        da.decode_attention(q, kc, vc, kv_len)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"decode_attention wrapper: {host / n * 1e6:.1f} us/call host, {wall / n * 1e6:.1f} us/call wall")

    prof = cProfile.Profile()
    prof.enable()
    for i in range(5):
        model.decode(params, {"token": tok}, cache, PROMPT + i, plan)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(25)
    print("cProfile of 5 decode steps (profiling itself slows the host):")
    print(out.getvalue())


if __name__ == "__main__":
    main()
