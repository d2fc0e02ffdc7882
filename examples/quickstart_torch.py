"""Quickstart, PyTorch/CUDA port: the public API in one page. The twin of
``examples/quickstart.py``, with the same four steps and the same printout.

Builds an LM from the assigned-architecture registry, trains it 30 steps on
deterministic synthetic data, saves a checkpoint, restores it, and generates
tokens with the KV-cached serving path.

On the GPU it runs llama3-8b at its full width (d_model 4096, 32 query heads
over 8 KV heads of 128, a 128,256-word untied head, rope theta 500,000) and
``LAYERS`` = 2 deep: the 32 layers' f32 parameters, gradients and AdamW
moments (16 bytes a parameter, 8 B parameters) exceed one card. The
CUDA kernels are compiled with nvcc at first use:

    PYTHONPATH=src python examples/quickstart_torch.py

Dry run of the same path on the CPU with the reference's reduced config:

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --reduced

The checkpoint goes to ``--ckpt-dir``, by default ``quickstart_ckpt`` in the
temporary directory (``/tmp/quickstart_ckpt`` where ``TMPDIR`` is unset, the
reference's path); a later save at the same step replaces it.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.runtime.serve_step import greedy_generate
from repro_torch.sharding.plan import make_plan

SUITE = ShapeSuite("quickstart", seq_len=64, global_batch=4, kind="train")
OPT = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=30)
STEPS = 30
NEW_TOKENS = 8
ARCH, LAYERS = "llama3-8b", 2


def quickstart_config(*, reduced: bool = False):
    """llama3-8b (its reduced config with ``reduced``), LAYERS deep, width kept."""
    cfg = get_config(ARCH)
    if reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=LAYERS)


def train(model, plan, cfg, state, device, *, steps: int = STEPS, opt_cfg=OPT):
    """``steps`` steps on the quickstart batches; returns (state, losses, grad norms)."""
    step = ts.build_train_step(model, plan, opt_cfg)
    losses, grad_norms = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in synthetic.batch_for(cfg, SUITE, seed=0, step=i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:3d}  loss={losses[-1]:.4f}  grad_norm={grad_norms[-1]:.3f}")
    return state, losses, grad_norms


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same type, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def state_leaves(state) -> list:
    """A train state's tensors: the parameters, AdamW's step and moments."""
    opt = state["opt"]
    return [*tree_leaves(state["params"]), opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v)]


def round_trip(state, ckpt_dir, step: int):
    """Saves ``state`` at ``step`` and restores it; returns (restored state,
    whether every restored leaf equals the saved one bit for bit, the store)."""
    store = CheckpointStore(ckpt_dir)
    store.save(step, state)
    restored, _ = store.restore(state)
    exact = all(bit_equal(a, b) for a, b in zip(state_leaves(restored), state_leaves(state), strict=True))
    return restored, exact, store


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "quickstart_ckpt"))
    args = ap.parse_args(argv)

    # 1. pick an assigned architecture; one device, so no mesh
    device = resolve_device(args.device)
    cfg = quickstart_config(reduced=args.reduced)
    model = build_model(cfg)
    plan = make_plan(cfg, None)

    # 2. train a few steps
    state = ts.init_train_state(model, torch.Generator(device=device).manual_seed(0), OPT, device)
    state, losses, grad_norms = train(model, plan, cfg, state, device)

    # 3. checkpoint round-trip
    state, exact, store = round_trip(state, args.ckpt_dir, STEPS)
    if not exact:
        raise RuntimeError(f"the checkpoint under {args.ckpt_dir} did not restore the saved state")
    print(f"checkpoint saved + restored at step {store.latest_step()}")

    # 4. generate with the KV-cached serving path
    prompt = torch.from_numpy(synthetic.token_batch(cfg.vocab, 2, 8, seed=1)["tokens"]).to(device)
    tokens = greedy_generate(model, state["params"], prompt, max_new=NEW_TOKENS, plan=plan)
    print(f"generated tokens:\n{tokens}")
    return {"config": cfg, "state": state, "losses": losses, "grad_norms": grad_norms,
            "ckpt_step": store.latest_step(), "ckpt_exact": exact, "prompt": prompt, "tokens": tokens}


if __name__ == "__main__":
    main()
