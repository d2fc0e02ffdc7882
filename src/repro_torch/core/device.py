"""Device-model API: first-class GPU SKU descriptors for the whole stack.

The paper measures one device — an A100-40GB — and until this module that
device was baked into the codebase as module-level globals (``PROFILES`` /
``N_UNITS`` / ``EXCLUSIONS`` in core/profiles.py, ``HBM_PER_CHIP`` in
telemetry/constants.py). A ``DeviceSKU`` makes the hardware an explicit
value instead: the slice-unit count, usable compute slices, per-slice HBM
budget, the placement tree of :class:`InstanceProfile` s, the documented
exclusion pairs, and the shared-mode knobs (dispatch-latency floor, naive
switch overhead, reconfiguration cost) all travel together, so the
scheduler, planner, sharing models, and cluster can be instantiated per
GPU generation — and a single fleet can mix generations.

Why it matters for the paper's question: MIGPerf (Zhang et al., 2023)
measures MIG behaviour differing materially across A100/A30-class parts
(different slice counts, different memory-per-slice, different
latency floors), and Flex-MIG-style fleets reason about MIG across
heterogeneous multi-tenant clusters. Whether collocation wins — and in
which mode — is a function of the *device model*, not a universal
constant; this module is the axis those questions are asked along.

Registry (``SKUS``):

  a100-40gb   the paper's device and the **default** — byte-identical
              behaviour to the old module globals (same tree, same 4g+3g
              exclusion, same 7-of-8 compute budget, same budgets);
  a100-80gb   the same placement tree with doubled per-slice memory
              (NVIDIA's 1g.10gb ... 7g.80gb ladder);
  h100-80gb   the Hopper tree — adds the double-width-memory ``1g.20gb``
              profile and a lower dispatch-latency floor / reconfig cost;
  a30-24gb    the 4-slice part (1g.6gb / 2g.12gb / 4g.24gb): MIGPerf's
              evidence that slice algebra is per-SKU, not per-architecture.

Memory currency. The TPU adaptation (core/partitioner.py) gives every chip
the same HBM, so a slice's budget is expressed *per chip*:
``DeviceSKU.slice_bytes`` is the per-chip HBM budget a job sees on any
slice of the SKU, with the A100-40GB pinned to the v5e 16 GiB baseline
(``telemetry.constants.HBM_PER_CHIP``) and other SKUs scaled by their real
memory-per-slice ratio (A100-80GB/H100: 10 GB vs 5 GB per slice -> 2x;
A30: 6 GB vs 5 GB -> 1.2x). Characterization records store per-chip peaks,
so admission is always ``peak_bytes_per_device <= sku.slice_bytes``.

Import discipline: this module sits below the scheduling stack (profiles,
planner, collocation, cluster import it — never the reverse; its only
core dependency is sharing.py's model constants, which imports nothing
back) and is jax-free.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

# sharing.py is the authority for the shared-mode *model* and its baseline
# constants; the SKU carries the per-device values threaded into it. It
# imports nothing from this module, so aliasing is cycle-free — a model
# recalibration there cannot silently diverge from the SKU defaults here.
from repro_torch.core.sharing import NAIVE_SWITCH_OVERHEAD_FRAC, STEP_LATENCY_S
from repro_torch.core.slice_unit import HBM_PER_CHIP

#: Baseline live re-partitioning downtime (drain + MIG destroy/create +
#: daemon restart). core/cluster.py's DEFAULT_RECONFIG_COST_S aliases this;
#: per-SKU values scale relative to it (see Cluster._device_reconfig_cost).
DEFAULT_RECONFIG_COST_S = 2.0


def format_gib(nbytes: float) -> str:
    """The one GiB formatter admission/rejection messages use, so the
    printed budget can never drift from the budget actually enforced."""
    return f"{nbytes / 2**30:.1f}"


@dataclasses.dataclass(frozen=True)
class InstanceProfile:
    """One MIG profile mapped to pod slice units."""

    name: str  # canonical MIG name, kept vendor-faithful
    compute_slices: int  # scales the analytical compute roof
    mem_units: int  # placement span in slice units
    starts: Tuple[int, ...]  # allowed start offsets (placement tree)

    @property
    def max_instances(self) -> int:
        return len(self.starts)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A profile instance at a slice-unit offset. SKU-agnostic data — the
    (profile, start) pair; geometry comes from the SKU that owns it."""

    profile: str
    start: int  # slice-unit offset

    @property
    def span(self) -> Tuple[int, int]:
        # default-SKU shim (the old ``profiles.Placement.span`` behaviour);
        # SKU-aware code uses ``sku.span(placement)`` instead.
        return DEFAULT_SKU.span(self)


@dataclasses.dataclass(frozen=True)
class DeviceSKU:
    """Frozen descriptor of one GPU generation's partitioning model.

    Hashable (all fields are), so enumeration memos (core/planner) and
    cost-model caches can key per SKU.
    """

    name: str
    n_units: int  # memory slice units (placement granularity)
    n_compute_slices: int  # usable compute slices when partitioned
    # per-chip HBM budget (model currency) of any slice of this SKU —
    # see the module docstring for the cross-SKU scaling convention
    slice_bytes: int
    profiles: Tuple[InstanceProfile, ...]  # the placement tree
    # vendor-documented invalid profile combinations (A100: 4g+3g)
    exclusions: Tuple[FrozenSet[str], ...] = ()
    full_profile: str = ""  # the profile shared modes (naive/MPS) run on
    # shared-mode knobs: per-step host dispatch + sync latency floor, and
    # the per-quantum switch penalty of naive time-slicing
    step_latency_s: float = STEP_LATENCY_S
    naive_switch_overhead_frac: float = NAIVE_SWITCH_OVERHEAD_FRAC
    # live re-partitioning downtime (MIG destroy/create + daemon restart);
    # the cluster charges its configured cost scaled by this value's ratio
    # to the baseline, so the operator flag and the SKU knob compose
    reconfig_cost_s: float = DEFAULT_RECONFIG_COST_S
    # per-slice-unit compute speed relative to the A100 baseline — the
    # analytic characterization (launch/simulate.py) divides busy terms by
    # it. Capacity differences (A30's 4 units vs 8) are expressed by the
    # tree itself; this is the *generation* speedup (H100's fatter MXUs).
    compute_scale: float = 1.0

    def __post_init__(self):
        names = [p.name for p in self.profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate profile names {names}")
        if self.full_profile not in names:
            raise ValueError(
                f"{self.name}: full_profile {self.full_profile!r} not in tree"
            )
        by_name = {p.name: p for p in self.profiles}
        if by_name[self.full_profile].mem_units != self.n_units:
            raise ValueError(
                f"{self.name}: full profile must own all {self.n_units} units"
            )
        for p in self.profiles:
            for s in p.starts:
                if s < 0 or s + p.mem_units > self.n_units:
                    raise ValueError(
                        f"{self.name}: {p.name} start {s} overflows "
                        f"{self.n_units} units"
                    )

    # -- tree lookups ------------------------------------------------------

    @functools.cached_property
    def profiles_by_name(self) -> Dict[str, InstanceProfile]:
        """Name -> profile, in tree order (the old ``PROFILES`` shape)."""
        return {p.name: p for p in self.profiles}

    @functools.cached_property
    def profile_order(self) -> Tuple[str, ...]:
        """Smallest profile first — the paper's throughput-maximizing
        packing order (matches the old hand-written ``_PROFILE_ORDER``)."""
        return tuple(
            sorted(
                self.profiles_by_name,
                key=lambda n: (
                    self.profiles_by_name[n].mem_units,
                    self.profiles_by_name[n].compute_slices,
                    n,
                ),
            )
        )

    def profile(self, name: str) -> InstanceProfile:
        p = self.profiles_by_name.get(name)
        if p is None:
            raise KeyError(
                f"profile {name!r} is not in the {self.name} placement tree "
                f"(has: {', '.join(self.profiles_by_name)})"
            )
        return p

    # -- geometry ----------------------------------------------------------

    def span(self, pl: Placement) -> Tuple[int, int]:
        p = self.profile(pl.profile)
        return (pl.start, pl.start + p.mem_units)

    def units(self, pl: Placement) -> FrozenSet[int]:
        s0, s1 = self.span(pl)
        return frozenset(range(s0, s1))

    def compute_discount(self, profile: str, *, partitioned: bool = True) -> float:
        """F6 analytically: an instance owns ``compute_slices/n_units`` of
        the device's compute but ``mem_units/n_units`` of its chips."""
        if not partitioned:
            return 1.0  # non-MIG: the full device, no reserved slice
        p = self.profile(profile)
        return min(1.0, p.compute_slices / p.mem_units)

    def instance_hbm_bytes(self, profile: str, chips_per_unit: int) -> int:
        return self.profile(profile).mem_units * chips_per_unit * self.slice_bytes

    # -- layout algebra ----------------------------------------------------

    def validate_layout(
        self, placements: Sequence[Placement], *, partitioned: bool = True
    ) -> Tuple[bool, str]:
        """Check instance placements against this SKU's placement tree —
        the same algebra the old module-level ``profiles.validate_layout``
        enforced for the A100-40GB."""
        names = [pl.profile for pl in placements]
        for pl in placements:
            if pl.profile not in self.profiles_by_name:
                return False, f"unknown profile {pl.profile}"
            p = self.profiles_by_name[pl.profile]
            if pl.start not in p.starts:
                return False, f"{pl.profile} may not start at unit {pl.start}"
        spans = sorted(self.span(pl) for pl in placements)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            if b0 < a1:
                return False, f"overlapping spans {(a0, a1)} and {(b0, b1)}"
        # compute-slice budget (the MIG overhead slice is a *compute*
        # budget, not a blocked memory unit — F6 lives in the per-profile
        # compute discount)
        total_c = sum(self.profiles_by_name[n].compute_slices for n in names)
        if total_c > self.n_compute_slices:
            return False, f"compute slices {total_c} > {self.n_compute_slices}"
        for bad in self.exclusions:
            if bad <= set(names):
                return False, f"excluded combination {sorted(bad)}"
        return True, ""

    def homogeneous_layout(self, profile: str) -> List[Placement]:
        """The paper's 'parallel' device group: max instances of one profile."""
        p = self.profile(profile)
        placements = []
        occupied = 0
        for s in p.starts:
            if s >= occupied:
                placements.append(Placement(profile, s))
                occupied = s + p.mem_units
        return placements


# -- registry -------------------------------------------------------------------

SKUS: Dict[str, DeviceSKU] = {}


def register_sku(sku: DeviceSKU) -> DeviceSKU:
    if sku.name in SKUS:
        raise ValueError(f"SKU {sku.name!r} already registered")
    SKUS[sku.name] = sku
    return sku


def get_sku(sku: Union[None, str, DeviceSKU]) -> DeviceSKU:
    """Resolve a SKU argument: None -> default, name -> registry lookup."""
    if sku is None:
        return DEFAULT_SKU
    if isinstance(sku, DeviceSKU):
        return sku
    found = SKUS.get(sku)
    if found is None:
        raise KeyError(
            f"unknown device SKU {sku!r}; registered: {', '.join(SKUS)}"
        )
    return found


#: The paper's device — the default everywhere, byte-identical to the old
#: module globals (tree, exclusion, budgets, knobs).
A100_40GB = register_sku(
    DeviceSKU(
        name="a100-40gb",
        n_units=8,
        n_compute_slices=7,
        slice_bytes=HBM_PER_CHIP,  # the v5e 16 GiB per-chip baseline
        profiles=(
            InstanceProfile("1g.5gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
            InstanceProfile("2g.10gb", 2, 2, (0, 2, 4)),
            InstanceProfile("3g.20gb", 3, 4, (0, 4)),
            InstanceProfile("4g.20gb", 4, 4, (0,)),
            InstanceProfile("7g.40gb", 7, 8, (0,)),
        ),
        exclusions=(frozenset({"4g.20gb", "3g.20gb"}),),
        full_profile="7g.40gb",
    )
)

#: Same placement tree as the A100-40GB, doubled per-slice memory — the
#: NVIDIA 1g.10gb ... 7g.80gb ladder. Big-memory jobs that OOM on every
#: 40GB slice fit here, which is what makes a mixed-generation fleet drain
#: a queue the 40GB part alone cannot.
A100_80GB = register_sku(
    DeviceSKU(
        name="a100-80gb",
        n_units=8,
        n_compute_slices=7,
        slice_bytes=2 * HBM_PER_CHIP,
        profiles=(
            InstanceProfile("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
            InstanceProfile("2g.20gb", 2, 2, (0, 2, 4)),
            InstanceProfile("3g.40gb", 3, 4, (0, 4)),
            InstanceProfile("4g.40gb", 4, 4, (0,)),
            InstanceProfile("7g.80gb", 7, 8, (0,)),
        ),
        exclusions=(frozenset({"4g.40gb", "3g.40gb"}),),
        full_profile="7g.80gb",
    )
)

#: Hopper: the A100-80GB ladder plus the double-width-memory 1g.20gb
#: profile (1 compute slice spanning 2 memory units), and a faster host
#: interface (lower dispatch-latency floor, cheaper reconfiguration).
H100_80GB = register_sku(
    DeviceSKU(
        name="h100-80gb",
        n_units=8,
        n_compute_slices=7,
        slice_bytes=2 * HBM_PER_CHIP,
        profiles=(
            InstanceProfile("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
            InstanceProfile("1g.20gb", 1, 2, (0, 2, 4, 6)),
            InstanceProfile("2g.20gb", 2, 2, (0, 2, 4)),
            InstanceProfile("3g.40gb", 3, 4, (0, 4)),
            InstanceProfile("4g.40gb", 4, 4, (0,)),
            InstanceProfile("7g.80gb", 7, 8, (0,)),
        ),
        exclusions=(frozenset({"4g.40gb", "3g.40gb"}),),
        full_profile="7g.80gb",
        step_latency_s=0.8e-3,
        reconfig_cost_s=1.5,
        compute_scale=2.0,
    )
)

#: The 4-slice part: 4 memory units, 4 compute slices, 6 GB per slice, no
#: documented exclusions, and no reserved compute slice (the full 4g.24gb
#: profile owns all four — A30 MIG pays no F6 tax in our algebra). MIGPerf
#: is the evidence that this tree behaves materially differently from the
#: A100's, which is exactly what a per-SKU device model exists to express.
A30_24GB = register_sku(
    DeviceSKU(
        name="a30-24gb",
        n_units=4,
        n_compute_slices=4,
        slice_bytes=(6 * HBM_PER_CHIP) // 5,  # 6 GB vs the A100's 5 GB slice
        profiles=(
            InstanceProfile("1g.6gb", 1, 1, (0, 1, 2, 3)),
            InstanceProfile("2g.12gb", 2, 2, (0, 2)),
            InstanceProfile("4g.24gb", 4, 4, (0,)),
        ),
        full_profile="4g.24gb",
    )
)

DEFAULT_SKU = A100_40GB
