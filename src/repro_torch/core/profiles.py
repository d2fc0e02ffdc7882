"""MIG-faithful instance profiles and the placement tree, adapted to pods.

The A100 exposes 8 memory slices and 7(+1 reserved) compute slices; profiles
combine them and may only start at fixed slice offsets (the *placement
tree*). We keep the algebra bit-faithful — profile names, spans, start
offsets, max instance counts, and the documented 4g+3g exclusion — and map
one *slice unit* onto a contiguous block of pod rows, so every instance is a
contiguous sub-rectangle of the chip grid and ICI traffic stays
intra-instance (the TPU analogue of MIG's hardware isolation).

The reserved 8th unit reproduces the paper's F6 finding (enabling MIG costs
one compute slice): ``partitioned=True`` keeps unit 7 for the control plane
and jobs may only use units 0..6 — except the full-device ``7g`` profile,
which owns all 8 memory units like MIG's 7g.40gb owns the full 40 GB.

Since the device-model API landed (core/device.py), the tree lives on a
:class:`~repro.core.device.DeviceSKU` and this module is the
**backwards-compatible view of the default SKU** (``a100-40gb`` — the
paper's device): ``PROFILES`` / ``N_UNITS`` / ``N_COMPUTE_SLICES`` /
``EXCLUSIONS`` are aliases of the default SKU's fields, and every function
takes an optional ``sku`` to operate on another registered generation.
New code should prefer ``device.get_sku(...)`` and the SKU methods
directly; these shims exist so the 12+ existing import sites (and any
external callers) keep working unchanged.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple, Union

# Re-exported for backwards compatibility: these classes moved to the
# device-model module so the SKU registry can own the placement tree.
from repro_torch.core.device import (  # noqa: F401
    DEFAULT_SKU,
    DeviceSKU,
    InstanceProfile,
    Placement,
    get_sku,
)
from repro_torch.core.slice_unit import HBM_PER_CHIP  # noqa: F401  (re-export)

SkuArg = Union[None, str, DeviceSKU]

N_UNITS = DEFAULT_SKU.n_units  # memory slice units (placement granularity)
N_COMPUTE_SLICES = DEFAULT_SKU.n_compute_slices  # usable when partitioned

# The five profiles the paper sweeps (A100-40GB placement tree) — the
# default SKU's own table, aliased.
PROFILES: Dict[str, InstanceProfile] = DEFAULT_SKU.profiles_by_name

# NVIDIA's documented invalid combination despite slices summing <= max
# (paper §2.1): one cannot create 4g.20gb + 3g.20gb together.
EXCLUSIONS: Tuple[FrozenSet[str], ...] = DEFAULT_SKU.exclusions


def validate_layout(
    placements: Sequence[Placement],
    *,
    partitioned: bool = True,
    sku: SkuArg = None,
) -> Tuple[bool, str]:
    """Check a set of instance placements against the placement tree."""
    return get_sku(sku).validate_layout(placements, partitioned=partitioned)


def homogeneous_layout(profile: str, sku: SkuArg = None) -> List[Placement]:
    """The paper's 'parallel' device group: max instances of one profile."""
    return get_sku(sku).homogeneous_layout(profile)


def enumerate_layouts(
    max_results: int = 64, sku: SkuArg = None
) -> List[Tuple[Placement, ...]]:
    """All valid (order-insensitive) layouts — scheduler search space.

    (The planner's ``enumerator.enumerate_configs`` is the memoized,
    exhaustive sibling; this bounded variant predates it and stays for the
    callers pinned to its ordering.)
    """
    dev = get_sku(sku)
    options = [
        Placement(p.name, s) for p in dev.profiles for s in p.starts
    ]
    results: List[Tuple[Placement, ...]] = []
    seen = set()

    def rec(chosen: List[Placement], rest: List[Placement]):
        if len(results) >= max_results:
            return
        key = frozenset((c.profile, c.start) for c in chosen)
        if chosen and key not in seen:
            ok, _ = dev.validate_layout(chosen)
            if ok:
                seen.add(key)
                results.append(tuple(sorted(chosen, key=lambda c: c.start)))
        for i, cand in enumerate(rest):
            ok, _ = dev.validate_layout(chosen + [cand])
            if ok:
                rec(chosen + [cand], rest[i + 1:])

    rec([], options)
    return results


def instance_hbm_bytes(
    profile: str, chips_per_unit: int, sku: SkuArg = None
) -> int:
    return get_sku(sku).instance_hbm_bytes(profile, chips_per_unit)
