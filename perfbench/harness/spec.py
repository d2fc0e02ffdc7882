"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (``perfbench/workloads/<cell>.json``) names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``), and holds the limits of its
correctness check. ``load(cell)`` joins the three into one plain dict, the
``spec`` that every other module of the harness reads. Nothing here knows a
cell, a configuration or a metric by name.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH_DIR = ROOT / "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def _named(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path.relative_to(ROOT)} is missing")
    return read_json(path)


def load(cell: str) -> dict:
    """The cell's spec: its workload file with ``config_data`` and
    ``traffic_data`` (the files it names) and its ``name``."""
    spec = _named("workloads", cell)
    spec["name"] = cell
    spec["config_data"] = _named("configs", spec["config"])
    spec["traffic_data"] = _named("traffic", spec["traffic"])
    return spec


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The entries of ``bench[section]`` that the cell reports: those whose
    ``workloads`` list it, or, without the key, those that move (or are) an
    end-to-end metric the cell reports."""
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in metrics_for(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
