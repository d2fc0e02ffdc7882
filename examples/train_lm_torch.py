"""End-to-end training, PyTorch/CUDA port: train a ~100M-parameter LM for a few
hundred steps. The twin of ``examples/train_lm.py``.

Uses the real launcher (``repro_torch.launch.train``: checkpointing, host
pipeline, resume) with the reference's ~100M-parameter llama-style config,
registered under ``lm-100m``, at its own size (12 layers, d_model 512, 8 query
heads over 4 KV heads of 64) and defaults (200 steps, batch 8, seq 256) on
the GPU:

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]

Dry run on the CPU with the config reduced:

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --reduced --steps 6

As in the reference, a run resumes from the latest checkpoint under
``--ckpt-dir`` (by default ``lm100m_ckpt`` in the temporary directory): pass
a fresh directory to train from step 0.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_cli
from repro_torch.models.model_api import build_model

# ~100M params: 12L, d=512, 8 heads, ffn 2048, 32k vocab
LM100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32_000,
    remat=False,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    args_in = ap.parse_args(argv)
    resolve_device(args_in.device)  # no card and no --device cpu: raise before anything is registered

    registry.CONFIGS["lm-100m"] = LM100M  # register for the launcher

    cfg = LM100M.reduced() if args_in.reduced else LM100M
    n = build_model(cfg).param_count()  # shapes only, on the meta device
    print(f"{cfg.name}{' (reduced)' if args_in.reduced else ''}: {n/1e6:.1f}M parameters")

    args = train_cli.build_argparser().parse_args(
        [
            "--arch", "lm-100m",
            "--steps", str(args_in.steps),
            "--batch", str(args_in.batch),
            "--seq", str(args_in.seq),
            "--ckpt-dir", args_in.ckpt_dir,
            "--ckpt-every", "50",
            "--log-every", "10",
            "--workers", "2",
            "--lr", "6e-4",
            "--device", args_in.device,
        ]
        + (["--reduced"] if args_in.reduced else [])
    )
    result = train_cli.run(args)
    print(
        f"\ntrained {result['steps']} steps: loss "
        f"{result['first_loss']:.3f} -> {result['final_loss']:.3f} "
        f"({result['mean_step_ms']:.0f} ms/step, "
        f"input-wait {result['pipeline']['input_wait_per_batch_ms']:.2f} ms/batch)"
    )
    if not result["final_loss"] < result["first_loss"]:
        raise RuntimeError(f"loss did not improve: {result['first_loss']} -> {result['final_loss']}")
    return result


if __name__ == "__main__":
    main()
