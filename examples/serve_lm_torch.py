"""Batched serving example, PyTorch/CUDA port: prefill a batch of prompts
once, then decode tokens step-by-step against the shared KV cache. The twin
of ``examples/serve_lm.py``, with the same printout.

Runs granite-3-2b at its full size on the GPU (the CUDA kernels are compiled
with nvcc at first use):

    PYTHONPATH=src python examples/serve_lm_torch.py

Dry run of the same path on the CPU with a tiny same-family config:

    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --reduced
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.runtime.serve_step import pad_cache
from repro_torch.sharding.plan import make_plan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=None, help="prompt length (2048; 32 with --reduced)")
    ap.add_argument("--new", type=int, default=None, help="new tokens (32; 16 with --reduced)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)

    B = args.batch
    S = args.prompt or (32 if args.reduced else 2048)
    NEW = args.new or (16 if args.reduced else 32)
    prompts = torch.from_numpy(
        synthetic.token_batch(cfg.vocab, B, S, seed=7)["tokens"]
    ).to(device)

    # prefill: one pass over the prompt batch, builds the KV cache
    _sync(device)
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": prompts}, plan)
    cache = pad_cache(cache, NEW)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    # decode: one token per step for the whole batch
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    out = [tok]
    t1 = time.perf_counter()
    for i in range(NEW - 1):
        logits, cache = model.decode(params, {"token": out[-1]}, cache, S + i, plan)
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    _sync(device)
    t_decode = time.perf_counter() - t1

    tokens = torch.stack(out, dim=1)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.name} on {where}")
    print(f"prefill: {B} x {S} tokens in {t_prefill*1e3:.0f} ms")
    print(
        f"decode:  {B} x {NEW} tokens in {t_decode*1e3:.0f} ms "
        f"({B * NEW / max(t_decode, 1e-9):.0f} tok/s batched)"
    )
    print(f"sampled continuation (first request): {tokens[0].tolist()}")


if __name__ == "__main__":
    main()
