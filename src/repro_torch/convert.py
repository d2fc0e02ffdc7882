"""Reference parameters -> port parameters.

The reference keeps its parameters as a nested dict of arrays with layer
parameters stacked on a leading ``L`` dim. The port keeps the same tree and
the same stacking, so conversion is leaf by leaf: names, shapes and types
are kept. The caller hands over numpy arrays (``jax.device_get`` of the
reference tree); nothing here imports the reference or its framework.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy knows no bfloat16 array: widen to float32 (exact,
        # every bfloat16 is a float32) and narrow again on the torch side
        # (exact for the same reason)
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # np.array copies: the source may be read-only


def from_jax_params(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on ``device``.

    bfloat16 leaves stay bfloat16, bit for bit; float32 leaves (norm scales)
    stay float32.
    """
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev)

    return walk(tree)
