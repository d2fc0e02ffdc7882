"""Reference parameters -> port parameters.

The reference keeps its parameters as a nested dict of arrays with layer
parameters stacked on a leading ``L`` dim (the ResNet's blocks are a list of
dicts, its conv weights HWIO). The port keeps the same tree, the same
stacking and the same layouts, so conversion is leaf by leaf: names, shapes
and types are kept. That holds for every family's tree: the MoE's experts
stacked on an E axis after L (``layers/moe/e_gate`` (L, E, d, f), the f32
router, the ``shared`` experts), zamba2's unstacked ``shared_attn`` block
beside its stacked mamba2 layers, whisper's ``enc_layers`` and
``dec_layers`` stacks. The caller hands over numpy arrays (``jax.device_get`` of the
reference tree); nothing here imports the reference or its framework.
``from_jax_train_state`` does the same for a whole train state
``{"params", "opt": AdamWState(step, m, v)}``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy knows no bfloat16 array: widen to float32 (exact,
        # every bfloat16 is a float32) and narrow again on the torch side
        # (exact for the same reason)
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # np.array copies: the source may be read-only


def from_jax_params(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dicts (and lists) of numpy arrays -> the same tree of tensors on ``device``.

    bfloat16 leaves stay bfloat16, bit for bit; float32 leaves (norm scales)
    stay float32.
    """
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(node, dev)

    return walk(tree)


def from_jax_train_state(state: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's ``{"params", "opt"}`` train state (numpy leaves) -> the port's.

    ``opt`` may be the reference's ``AdamWState`` or any object with ``step``,
    ``m`` and ``v``; the step becomes a 0-d int32 tensor, m and v stay f32.
    """
    opt = state["opt"]
    return {
        "params": from_jax_params(state["params"], device),
        "opt": AdamWState(
            step=from_jax_params({"step": np.asarray(opt.step, dtype=np.int32)}, device)["step"],
            m=from_jax_params(opt.m, device),
            v=from_jax_params(opt.v, device),
        ),
    }
