"""Card partitioner: MIG placements -> instances of one CUDA device (PyTorch
twin of ``repro.core.partitioner``).

The reference maps a MIG slice unit to a block of rows of a TPU pod's chip
grid and carves each placement's sub-rectangle into a ``Mesh``. On one card a
placement is what MIG makes of it: a span of the card's memory units and
their share of its memory. An ``InstanceDevice`` holds the placement, the
``torch.device``, the span and the instance's memory budget, the card's
``total_memory x mem_units / n_units``: 10 GB a unit on an 80 GB card, as
NVIDIA's ``1g.10gb`` says.

The port does not carve real MIG instances: that needs root and
``nvidia-smi -mig``. Every instance names the one device, and the
characterization prices each from the job measured on the whole card
(``core/instance.py``). ``device_grid``, ``rows_per_unit``, ``instance_mesh``
and ``profile_mesh_shape`` have no counterpart: they arrange and cut a grid of
chips, and one card has none. ``partition_homogeneous`` has one: it cuts no
grid, only lays out the most instances of one profile.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.device import get_sku
from repro_torch.core.profiles import Placement, homogeneous_layout


def device_memory_bytes(device: torch.device) -> int:
    """The device's memory: the card's total, or the host's on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


@dataclasses.dataclass(frozen=True)
class InstanceDevice:
    """One GPU-instance analogue: a placement bound to a span of the card."""

    placement: Placement
    device: torch.device
    units: Tuple[int, int]  # [first, last + 1) memory units of the card
    hbm_budget_bytes: int

    @property
    def profile(self) -> str:
        return self.placement.profile

    @property
    def label(self) -> str:
        return f"{self.profile}@{self.placement.start}"


def partition(
    device: torch.device,
    placements: Sequence[Placement],
    *,
    partitioned: bool = True,
    sku=None,
) -> List[InstanceDevice]:
    """Validate a layout against the placement tree and bind each placement
    to its memory units of ``device``."""
    dev = get_sku(sku)
    ok, why = dev.validate_layout(placements, partitioned=partitioned)
    if not ok:
        raise ValueError(f"invalid MIG layout: {why}")
    total = device_memory_bytes(device)
    return [
        InstanceDevice(
            placement=pl,
            device=device,
            units=dev.span(pl),
            hbm_budget_bytes=total * dev.profile(pl.profile).mem_units // dev.n_units,
        )
        for pl in placements
    ]


def partition_homogeneous(device: torch.device, profile: str, *, sku=None, **kw) -> List[InstanceDevice]:
    """The paper's 'parallel' device group: max instances of one profile
    (seven ``1g.10gb`` instances of an ``h100-80gb``, each one memory unit)."""
    return partition(device, homogeneous_layout(profile, sku=sku), sku=sku, **kw)


def verify_disjoint(instances: Sequence[InstanceDevice]) -> None:
    """Isolation precondition: no memory unit may belong to two instances."""
    seen: Dict[int, str] = {}
    for inst in instances:
        for unit in range(*inst.units):
            if unit in seen:
                raise AssertionError(
                    f"memory unit {unit} shared by {seen[unit]} and {inst.label}"
                )
            seen[unit] = inst.label
