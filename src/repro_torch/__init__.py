"""PyTorch/CUDA port of the ``repro`` package.

Same directory and module names as ``repro`` so a reader finds the
counterpart of every function; PyTorch idiom inside: plain functions on
tensors, nested dicts of parameters, an explicit ``device`` argument on every
entry point and explicit ``torch.Generator``s. The package imports ``torch``
and numpy only: never ``jax`` and nothing of ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to the GPU and raise when there is none: nothing in
    the package moves work to the CPU on its own. Tests and dry runs pass
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' for a CPU dry run"
        )
    return dev
