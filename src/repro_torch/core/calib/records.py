"""Versioned characterization records with provenance.

The whole decision stack — greedy packing, the planner cost model, shared-
mode contention, the cluster's completion clocks — prices jobs off
characterization records keyed ``(arch, shape, profile)``. Until this
module those records were bare dicts with no history: a hand-extrapolated
H100 constant looked exactly like a number measured on hardware, and
nothing downstream could tell the difference (the ROADMAP's "extrapolated
constants with no measurement path behind them").

A :class:`CharRecord` is the same record made accountable: the numeric
fields the schedulers read, plus *provenance* — where the number came
from — and the measurement metadata (backend, sample count) when there is
any. A :class:`CharDB` is one SKU's set of records as a versioned,
JSON-round-trippable document (``calib_char_db/v1``), convertible to and
from the plain ``{(arch, shape, profile): dict}`` mapping every existing
consumer takes, so calibration composes with the scheduler stack without
touching its call signatures.

Provenance states (ordered weakest to strongest trust):

  ``extrapolated``  hand-seeded analytic constants (the synthetic catalog;
                    every pre-calibration DB loads as this);
  ``predicted``     derived from a *measured* full-device record by the
                    MISO-style slice scaling (core/planner/costmodel
                    ``predict_record``) — one real measurement priced the
                    slice, but the slice itself was never run;
  ``refined``       an extrapolated record corrected by fitted residuals
                    (core/calib/fit) or online EWMA corrections — better
                    than the seed, still not a measurement;
  ``measured``      a calibration backend actually ran the (arch, shape,
                    slice) cell (core/calib/harness) — MIGPerf's
                    per-(model, slice) ground truth.

``merge`` prefers stronger provenance at equal keys, so re-running a
partial calibration can only upgrade a DB, never silently downgrade a
measured entry back to a guess. Everything here is jax-free stdlib.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Mapping, Optional, Tuple

CharKey = Tuple[str, str, str]  # (arch, shape/suite, profile)

SCHEMA = "calib_char_db/v1"

#: Legal provenance states, weakest trust first — ``merge`` keeps the
#: entry whose provenance ranks higher at an equal key.
PROVENANCES: Tuple[str, ...] = (
    "extrapolated",
    "refined",
    "predicted",
    "measured",
)
_RANK = {p: i for i, p in enumerate(PROVENANCES)}

#: What the hand-seeded synthetic catalogs (launch/simulate.py) are worth
#: per SKU: the paper measured the A100-40GB — its catalog terms are
#: anchored to those numbers — while every other generation's entries are
#: scaled constants with no measurement path behind them.
SEED_PROVENANCE: Dict[str, str] = {
    "a100-40gb": "measured",
    "a100-80gb": "extrapolated",
    "h100-80gb": "extrapolated",
    "a30-24gb": "extrapolated",
}
DEFAULT_SEED_PROVENANCE = "extrapolated"


def seed_provenance(sku_name: str) -> str:
    """Provenance of a SKU's hand-seeded catalog entries."""
    return SEED_PROVENANCE.get(sku_name, DEFAULT_SEED_PROVENANCE)


@dataclasses.dataclass(frozen=True)
class CharRecord:
    """One (arch, shape, profile) characterization entry with provenance."""

    arch: str
    shape: str  # suite name
    profile: str
    step_s: float
    compute_s: float
    memory_s: float
    collective_s: float
    peak_bytes_per_device: float
    fits: bool
    provenance: str = "extrapolated"
    source: str = ""  # backend / "seed" / "fit" — where the number came from
    n_samples: int = 0  # measurement repetitions (0 for analytic entries)

    def __post_init__(self) -> None:
        if self.provenance not in _RANK:
            raise ValueError(
                f"unknown provenance {self.provenance!r}; "
                f"choose from {PROVENANCES}"
            )

    @property
    def key(self) -> CharKey:
        return (self.arch, self.shape, self.profile)

    def to_entry(self) -> Dict:
        """The scheduler-facing record dict (collocation / planner /
        cluster all read these keys; extra keys are inert to them)."""
        return {
            "fits": self.fits,
            "step_s": self.step_s,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "provenance": self.provenance,
        }

    @classmethod
    def from_entry(
        cls,
        key: CharKey,
        rec: Mapping,
        *,
        provenance: Optional[str] = None,
        source: str = "",
        n_samples: int = 0,
    ) -> "CharRecord":
        """Wrap a plain record dict. ``provenance`` overrides; otherwise
        the record's own ``provenance`` key wins, falling back to
        ``extrapolated`` — the hand-seeded default the tentpole pins."""
        arch, shape, profile = key
        step = float(rec.get("step_s", 0.0))
        return cls(
            arch=arch,
            shape=shape,
            profile=profile,
            step_s=step,
            compute_s=float(rec.get("compute_s", step)),
            memory_s=float(rec.get("memory_s", 0.0)),
            collective_s=float(rec.get("collective_s", 0.0)),
            peak_bytes_per_device=float(rec.get("peak_bytes_per_device", 0.0)),
            fits=bool(rec.get("fits", False)),
            provenance=(
                provenance
                if provenance is not None
                else str(rec.get("provenance", DEFAULT_SEED_PROVENANCE))
            ),
            source=source,
            n_samples=int(n_samples),
        )


class CharDB:
    """One SKU's characterization records as a versioned document.

    Mutably accumulates records (``add`` / ``merge``); converts losslessly
    to/from JSON (``to_doc``/``from_doc``/``dumps``/``loads``) and down to
    the plain mapping the scheduler stack consumes (``to_plain_db``).
    """

    def __init__(
        self,
        sku: str,
        records: Optional[Iterable[CharRecord]] = None,
        *,
        seed: Optional[int] = None,
    ) -> None:
        self.sku = sku
        self.seed = seed
        self.records: Dict[CharKey, CharRecord] = {}
        for rec in records or ():
            self.records[rec.key] = rec

    # -- construction ---------------------------------------------------

    @classmethod
    def from_plain_db(
        cls,
        db: Mapping[CharKey, Mapping],
        *,
        sku: str,
        provenance: Optional[str] = None,
        source: str = "seed",
        seed: Optional[int] = None,
    ) -> "CharDB":
        """Load an existing hand-seeded ``{key: dict}`` DB. Entries keep
        their own ``provenance`` key when present; bare entries load as
        ``extrapolated`` unless ``provenance`` overrides."""
        out = cls(sku, seed=seed)
        for key in sorted(db):
            out.records[key] = CharRecord.from_entry(
                key, db[key], provenance=provenance, source=source
            )
        return out

    # -- mutation -------------------------------------------------------

    def add(self, rec: CharRecord) -> None:
        self.records[rec.key] = rec

    def merge(self, records: Iterable[CharRecord]) -> int:
        """Fold ``records`` in, keeping the stronger provenance at equal
        keys (ties go to the incoming record — fresher data). Returns how
        many entries changed."""
        changed = 0
        for rec in records:
            cur = self.records.get(rec.key)
            if cur is not None and _RANK[cur.provenance] > _RANK[rec.provenance]:
                continue
            if cur != rec:
                changed += 1
            self.records[rec.key] = rec
        return changed

    # -- views ----------------------------------------------------------

    def to_plain_db(self) -> Dict[CharKey, Dict]:
        """The ``{(arch, shape, profile): dict}`` mapping every scheduler
        consumer takes (CollocationScheduler / PlanningCostModel /
        Cluster)."""
        return {key: rec.to_entry() for key, rec in sorted(self.records.items())}

    def provenance_counts(self) -> Dict[str, int]:
        counts = {p: 0 for p in PROVENANCES}
        for rec in self.records.values():
            counts[rec.provenance] += 1
        return {p: n for p, n in counts.items() if n}

    def __len__(self) -> int:
        return len(self.records)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, CharDB)
            and self.sku == other.sku
            and self.seed == other.seed
            and self.records == other.records
        )

    # -- serialization --------------------------------------------------

    def to_doc(self) -> Dict:
        """Versioned JSON-ready document; records sorted by key so equal
        DBs serialize byte-identically."""
        return {
            "schema": SCHEMA,
            "sku": self.sku,
            "seed": self.seed,
            "records": [
                dataclasses.asdict(rec)
                for _, rec in sorted(self.records.items())
            ],
        }

    @classmethod
    def from_doc(cls, doc: Mapping) -> "CharDB":
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a {SCHEMA} document: schema={doc.get('schema')!r}"
            )
        return cls(
            str(doc["sku"]),
            (CharRecord(**rec) for rec in doc.get("records", ())),
            seed=doc.get("seed"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_doc(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def loads(cls, text: str) -> "CharDB":
        return cls.from_doc(json.loads(text))
