"""Partition-tree enumerator: every valid MIG reconfiguration profile.

The A100 exposes ~19 canonical partition configs; under our paper-faithful
algebra (five profiles, fixed start offsets, the 4g+3g exclusion, and the
7-slice compute budget of core/profiles.py) the same search yields 18
*maximal* configs out of 296 valid non-empty layouts — small enough that the
placement optimizer can afford exact search over all of them.

Enumeration is **per device SKU** (core/device.py): every function takes an
optional ``sku`` and defaults to the A100-40GB, and the memo tables key on
the (hashable, frozen) SKU descriptor — so an A30's 4-slice tree and an
H100's 1g.20gb-bearing tree each get their own canonical-config universe
without cross-contaminating the default one (tests/test_device.py pins the
per-SKU counts).

Canonical form: a layout is a set of placements; its canonical form is the
tuple sorted by (start, profile). Enumeration is memoized (each SKU's
placement tree is a process-wide constant) and deterministic: the same call
always returns the same tuple, in the same order, with no duplicates —
tests/test_planner.py pins all three properties plus the partitioner
invariants (disjoint spans == ``verify_disjoint``, compute budget within
the SKU's slice budget).

Incremental transitions: ``expansions(existing)`` returns every valid config
reachable from a live layout by only *creating* instances (running jobs keep
their placements — MIG instance creation does not disturb neighbours, the
F3 isolation the cluster's incremental admission relies on). A full
re-partition (destroying instances) is a plan the cluster must charge
checkpoint-rollback + downtime for; ``transition`` reports exactly which
instances such a plan keeps, destroys, and creates.
"""
from __future__ import annotations

import functools
from typing import Dict, FrozenSet, List, Sequence, Tuple

from repro_torch.core.device import DeviceSKU, Placement, get_sku

Config = Tuple[Placement, ...]


def canonical_form(placements: Sequence[Placement]) -> Config:
    """Order-insensitive canonical form: sorted by (start, profile)."""
    return tuple(sorted(placements, key=lambda pl: (pl.start, pl.profile)))


def _all_options(sku: DeviceSKU) -> Tuple[Placement, ...]:
    return tuple(
        Placement(p.name, s) for p in sku.profiles for s in p.starts
    )


@functools.lru_cache(maxsize=None)
def _enumerate_cached(sku: DeviceSKU, partitioned: bool) -> Tuple[Config, ...]:
    options = _all_options(sku)
    seen: Dict[Tuple, Config] = {}

    def rec(chosen: List[Placement], rest: Tuple[Placement, ...]) -> None:
        for i, cand in enumerate(rest):
            trial = chosen + [cand]
            ok, _ = sku.validate_layout(trial, partitioned=partitioned)
            if not ok:
                continue
            cfg = canonical_form(trial)
            key = tuple((pl.start, pl.profile) for pl in cfg)
            if key not in seen:
                seen[key] = cfg
            rec(trial, rest[i + 1 :])

    rec([], options)
    return tuple(
        sorted(
            seen.values(),
            key=lambda cfg: (
                len(cfg),
                tuple((pl.start, pl.profile) for pl in cfg),
            ),
        )
    )


def enumerate_configs(partitioned: bool = True, sku=None) -> Tuple[Config, ...]:
    """All valid non-empty layouts of the SKU's placement tree,
    canonicalized, deterministically ordered (by size, then
    lexicographically), memoized per SKU."""
    return _enumerate_cached(get_sku(sku), partitioned)


@functools.lru_cache(maxsize=None)
def _maximal_cached(sku: DeviceSKU, partitioned: bool) -> Tuple[Config, ...]:
    options = _all_options(sku)
    out = []
    for cfg in _enumerate_cached(sku, partitioned):
        have = set(cfg)
        addable = any(
            sku.validate_layout(list(cfg) + [o], partitioned=partitioned)[0]
            for o in options
            if o not in have
        )
        if not addable:
            out.append(cfg)
    return tuple(out)


def maximal_configs(partitioned: bool = True, sku=None) -> Tuple[Config, ...]:
    """Configs to which no further instance can be added — the analogue of
    the vendor's canonical partition profiles (18 under the A100-40GB
    algebra; other SKUs have their own counts)."""
    return _maximal_cached(get_sku(sku), partitioned)


@functools.lru_cache(maxsize=None)
def _multisets_cached(
    sku: DeviceSKU, partitioned: bool
) -> Tuple[Tuple[str, ...], ...]:
    return tuple(
        sorted(
            {
                tuple(sorted(pl.profile for pl in cfg))
                for cfg in _enumerate_cached(sku, partitioned)
            }
        )
    )


def profile_multisets(
    partitioned: bool = True, sku=None
) -> Tuple[Tuple[str, ...], ...]:
    """Distinct profile combinations over all valid layouts (start-blind)."""
    return _multisets_cached(get_sku(sku), partitioned)


@functools.lru_cache(maxsize=None)
def _expansions_cached(
    sku: DeviceSKU,
    existing: Config,
    blocked_units: FrozenSet[int],
    partitioned: bool,
) -> Tuple[Config, ...]:
    have = set(existing)
    out = []
    for cfg in _enumerate_cached(sku, partitioned):
        if not have <= set(cfg):
            continue
        new = [pl for pl in cfg if pl not in have]
        if any(sku.units(pl) & blocked_units for pl in new):
            continue
        out.append(cfg)
    if not existing:
        # the empty layout itself is a legal (trivial) target
        out.insert(0, ())
    else:
        out.insert(0, existing)
    return tuple(dict.fromkeys(out))


def expansions(
    existing: Sequence[Placement] = (),
    *,
    blocked_units: FrozenSet[int] = frozenset(),
    partitioned: bool = True,
    sku=None,
) -> Tuple[Config, ...]:
    """Every valid config reachable from ``existing`` by only creating
    instances (supersets of the live layout), with no new instance touching
    a blocked (failed) slice unit. Includes ``existing`` itself (the
    zero-transition plan). ``existing`` must already be a valid layout."""
    dev = get_sku(sku)
    cfg = canonical_form(existing)
    if cfg:
        ok, why = dev.validate_layout(cfg, partitioned=partitioned)
        if not ok:
            raise ValueError(f"existing layout invalid: {why}")
    return _expansions_cached(dev, cfg, frozenset(blocked_units), partitioned)


@functools.lru_cache(maxsize=None)
def _free_cached(
    sku: DeviceSKU,
    existing: Config,
    blocked_units: FrozenSet[int],
    partitioned: bool,
) -> Tuple[Placement, ...]:
    have = set(existing)
    base = list(existing)
    out = []
    for cand in _all_options(sku):
        if cand in have or sku.units(cand) & blocked_units:
            continue
        if sku.validate_layout(base + [cand], partitioned=partitioned)[0]:
            out.append(cand)
    return tuple(out)


def free_placements(
    existing: Sequence[Placement] = (),
    *,
    blocked_units: FrozenSet[int] = frozenset(),
    partitioned: bool = True,
    sku=None,
) -> Tuple[Placement, ...]:
    """Placements individually addable to ``existing`` (one-step moves).
    Memoized on the canonical form — the optimizer's innermost loop."""
    return _free_cached(
        get_sku(sku), canonical_form(existing), frozenset(blocked_units),
        partitioned,
    )


def flexibility(
    layout: Sequence[Placement] = (),
    *,
    blocked_units: FrozenSet[int] = frozenset(),
    partitioned: bool = True,
    sku=None,
) -> int:
    """How much future capacity a layout preserves: the number of distinct
    placements still addable to it. The optimizer uses this as its final
    tie-break, which is what steers 1g jobs away from the start offsets
    whose occupation strands the larger profiles' few legal starts — the
    fragmentation greedy first-fit walks straight into."""
    return len(
        free_placements(
            layout, blocked_units=blocked_units, partitioned=partitioned,
            sku=sku,
        )
    )


def transition(
    current: Sequence[Placement], target: Sequence[Placement]
) -> Tuple[Config, Config, Config]:
    """(kept, destroyed, created) instance sets of a re-partition plan.

    ``destroyed`` is what the cluster must charge for: each destroyed
    instance's job rolls back to its last checkpoint and the device pays
    reconfiguration downtime (core/cluster.py). ``kept`` instances run
    through the reconfiguration untouched (F3 isolation)."""
    cur, tgt = set(current), set(target)
    return (
        canonical_form(cur & tgt),
        canonical_form(cur - tgt),
        canonical_form(tgt - cur),
    )
