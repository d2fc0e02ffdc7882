"""On the card only (the ``card`` fixture skips without one): a short run of
every cell prints a result line of the contract's shape with ``correct``
true, and the control at the cell's own size, on one seed, reads past the
cell's limits.

    python -m pytest -q perfbench/tests/test_perfbench_card.py
"""
import json
import subprocess
import sys

import pytest

from harness import check, spec as specs

CELLS = [w["name"] for w in specs.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, str(specs.BENCH_DIR / "run.py"), "--workload", cell, "--seed",
                          str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=str(specs.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    bench = specs.benchmark()
    section = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) <= {m["name"] for m in specs.metrics_for(bench, cell, section)}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in specs.metrics_for(bench, cell, section)}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_full_size_is_not_correct(card, cell):
    from harness.job import Job
    from reference import train as ref

    spec = specs.load(cell)
    job = Job(spec, 2**31 + 13, card)
    job.free()
    n, low = spec["traffic_data"]["checked_steps"], spec["config_data"]["precision"]["control"]
    base = ref.follow(spec, 2**31 + 13, job.layout, n, card)
    control = check.numbers(ref.follow(spec, 2**31 + 13, job.layout, n, card, low), base)
    assert not check.verdict(control, spec["limits"]), control
