"""Device meshes — the PyTorch twin of ``repro.launch.mesh``.

Functions, never module-level constants: importing this module touches no
device and no process group. Each builds a ``torch.distributed`` ``DeviceMesh``
with ``init_device_mesh`` over the ranks of the default process group, which
the caller has started (``torchrun``, or ``init_process_group`` with a store):
the mesh's size must be the world's.
"""
from __future__ import annotations

import math

from repro_torch import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device=device)


def make_mesh_shape(shape, axes, *, device="cuda"):
    """A mesh of ``shape`` over the named ``axes`` on ``device``'s type: the
    card's by default, which raises where there is none (``device="cpu"`` for
    a gloo mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_chips(mesh) -> int:
    return math.prod(mesh.mesh.shape)


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)
