"""The comparison that decides ``correct``.

Both sides give a readout of the first steps of a job: each step's loss, each
leaf's norm of the first gradient as the optimizer took it, and each leaf's
norm of its change after the last step followed. Three numbers compare them:

  * ``loss``: the largest |loss - reference| / |reference| over the steps
    (over the first ``loss_steps`` of them where the cell says so);
  * ``grad``: over the leaves, the largest |norm - reference's norm| over
    the larger of the reference's norm of that leaf and of the median leaf;
  * ``update``: the same of the change's norms.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's are left out of ``grad`` and ``update``: they move by
round-off alone. A number that is not finite reads infinite. A job is
correct when every number is at most its limit.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss", "grad", "update")
#: a leaf counts where its reference gradient is at least this share of the median leaf's
KEEP = 1e-3


def _leaf_gaps(got: dict, ref: dict, keep) -> dict:
    floor = statistics.median(ref[k] for k in keep)
    return {k: abs(got.get(k, math.nan) - ref[k]) / max(ref[k], floor, 1e-30) for k in keep}


def _worst(gaps: dict) -> float:
    return max((math.inf if not math.isfinite(g) else g for g in gaps.values()), default=0.0)


def numbers(got: dict, ref: dict, loss_steps=None, details=False) -> dict:
    """The three numbers; with ``details`` also each number's worst step or
    leaf (``<number>_at``)."""
    med = statistics.median(ref["grad"].values())
    keep = [k for k, n in ref["grad"].items() if n >= KEEP * med]
    out = {}
    steps = len(ref["losses"]) if loss_steps is None else loss_steps
    if len(got["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, got["losses"])):
        out["loss"], at = math.inf, None
    else:
        gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"][:steps], ref["losses"][:steps])]
        out["loss"], at = max(gaps), gaps.index(max(gaps)) + 1
    leaf = {"grad": _leaf_gaps(got["grad"], ref["grad"], keep),
            "update": _leaf_gaps(got["update"], ref["update"], keep)}
    out["grad"], out["update"] = _worst(leaf["grad"]), _worst(leaf["update"])
    if details:
        out["loss_at"] = at
        for k, gaps in leaf.items():
            out[f"{k}_at"] = max(gaps, key=lambda n: gaps[n] if math.isfinite(gaps[n]) else math.inf)
    return out


def worst(per_job: list) -> dict:
    """Each number's largest reading over the jobs."""
    return {k: max(n[k] for n in per_job) for k in NUMBERS}


def verdict(nums: dict, limits: dict) -> bool:
    return all(nums[k] <= limits[k] for k in NUMBERS)


def report(nums: dict, limits: dict) -> dict:
    return {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
