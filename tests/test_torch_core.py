"""The port's scheduling core against the reference's: every copied module is
the reference's source but for its import lines, and the scheduler algebra
gives the same Python floats on every SKU of the device model.
"""
import dataclasses
import importlib
import inspect

import numpy as np
import pytest

from repro.configs.base import ShapeSuite as JSuite
from repro.core import instance as jinstance
from repro.core import interference as jinterference
from repro.core import metrics as jmetrics
from repro.core.collocation import paper_experiment_grid as jgrid
from repro.core.device import SKUS as JSKUS
from repro.core.planner import PlanningCostModel as JCost
from repro.core.planner import enumerate_configs as jenumerate
from repro.core.planner import plan_placements as jplan
from repro.core.profiles import homogeneous_layout as jhomogeneous
from repro.core.sharing import CollocationMode as JMode
from repro.core.sharing import SoloProfile as JSolo
from repro.core.sharing import shared_mode_report as jshared
from repro.launch import lowering as jlowering
from repro.telemetry import constants as JC
from repro.telemetry import hlo as jhlo
from repro.telemetry import roofline as jroofline
from repro_torch.configs.base import ShapeSuite
from repro_torch.core import instance as tinstance
from repro_torch.core import interference as tinterference
from repro_torch.core import metrics as tmetrics
from repro_torch.core.collocation import paper_experiment_grid as tgrid
from repro_torch.core.device import SKUS as TSKUS
from repro_torch.core.planner import PlanningCostModel as TCost
from repro_torch.core.planner import enumerate_configs as tenumerate
from repro_torch.core.planner import plan_placements as tplan
from repro_torch.core.profiles import homogeneous_layout as thomogeneous
from repro_torch.core.sharing import CollocationMode as TMode
from repro_torch.core.sharing import SoloProfile as TSolo
from repro_torch.core.sharing import shared_mode_report as tshared
from repro_torch.launch import lowering as tlowering
from repro_torch.telemetry import constants as TC
from repro_torch.telemetry import counts as tcounts
from repro_torch.telemetry import roofline as troofline

COPIED = (
    "core.sharing", "core.device", "core.profiles", "core.workload", "core.collocation",
    "core.metrics", "core.planner", "core.planner.costmodel", "core.planner.enumerator",
    "core.planner.optimizer", "core.gang", "core.gang.parallelism", "core.gang.comms",
    # the event-driven cluster and its subsystems
    "core.events", "core.queueing", "core.obs", "core.obs.recorder", "core.obs.perfetto",
    "core.forecast", "core.forecast.estimator", "core.forecast.policy", "core.gang.placement",
    "core.elastic", "core.calib.records", "core.calib.fit", "core.calib.online", "core.cluster",
    "launch.traces",
)
# functions and classes copied into modules that are otherwise rewritten
COPIED_PARTS = (
    (jinstance, tinstance, ("compute_discount", "JobSpec", "InstanceRecord")),
    (jinterference, tinterference, ("IsolationReport", "check_program_equivalence", "InterferenceQuant",
                                    "quant_from_report", "quantify_interference")),
    (jlowering, tlowering, ("active_params",)),
    (jroofline, troofline, ("model_flops", "format_table")),
    (jhlo, tcounts, ("CollectiveOp",)),
)
SLICE_UNIT_IMPORT = "from repro_torch.core.slice_unit import HBM_PER_CHIP"


def as_reference(source: str) -> str:
    """The port's source with its import lines turned back into the reference's."""
    lines = []
    for line in source.replace(SLICE_UNIT_IMPORT, "from repro.telemetry.constants import HBM_PER_CHIP").splitlines():
        if line.lstrip().startswith(("from repro_torch.", "import repro_torch.")):
            line = line.replace("repro_torch.", "repro.", 1)
        lines.append(line)
    return "\n".join(lines) + ("\n" if source.endswith("\n") else "")


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_is_the_reference_but_for_its_imports(name):
    want = inspect.getsource(importlib.import_module(f"repro.{name}"))
    got = inspect.getsource(importlib.import_module(f"repro_torch.{name}"))
    assert as_reference(got) == want


@pytest.mark.parametrize("ref,port,names", COPIED_PARTS, ids=lambda x: getattr(x, "__name__", None))
def test_copied_parts_are_the_reference(ref, port, names):
    for n in names:
        assert as_reference(inspect.getsource(getattr(port, n))) == inspect.getsource(getattr(ref, n)), n


def test_the_slice_unit_is_the_reference_currency_and_the_card_is_the_h100():
    from repro_torch.core import slice_unit

    assert slice_unit.HBM_PER_CHIP == JC.HBM_PER_CHIP == 16 * 1024**3
    assert TSKUS["a100-40gb"].slice_bytes == JSKUS["a100-40gb"].slice_bytes
    assert (TC.PEAK_FLOPS_BF16, TC.PEAK_FLOPS_F32, TC.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert not hasattr(TC, "HBM_PER_CHIP")


def test_roofline_computes_what_the_reference_computes_on_the_same_constants(monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW"):
        monkeypatch.setattr(JC, name, getattr(TC, name))
    kw = dict(arch="a", shape="s", mesh="m", chips=3, flops_per_device=7.1e12, hbm_bytes_per_device=2.3e11,
              wire_bytes_per_device=4.4e9, model_flops_global=1.9e13, peak_mem_bytes_per_device=5e9)
    want, got = jroofline.RooflineReport(**kw), troofline.RooflineReport(**kw)
    assert got.to_dict() == want.to_dict()
    assert troofline.dcgm_analogues(got) == jroofline.dcgm_analogues(want)
    # the one field the reference has not: the peak of an f32 step
    f32 = troofline.RooflineReport(**kw, peak_flops=TC.PEAK_FLOPS_F32)
    assert f32.compute_s == kw["flops_per_device"] / 67e12


def _sku_names():
    return list(JSKUS)


def test_the_sku_registries_agree():
    assert list(TSKUS) == list(JSKUS) == ["a100-40gb", "a100-80gb", "h100-80gb", "a30-24gb"]


def _placements(ps):
    return [(p.profile, p.start) for p in ps]


@pytest.mark.parametrize("sku", _sku_names())
def test_partition_tree_and_paper_grid_are_the_references(sku):
    assert len(tenumerate(sku=sku)) == len(jenumerate(sku=sku))
    assert len(tenumerate(partitioned=False, sku=sku)) == len(jenumerate(partitioned=False, sku=sku))
    if sku == "a100-40gb":
        assert len(tenumerate()) == 296
    assert [_placements(c) for c in tenumerate(sku=sku)] == [_placements(c) for c in jenumerate(sku=sku)]
    want = jgrid(["resnet_small", "resnet_large"], JSuite("t", 1024, 32, "train"), sku=sku)
    got = tgrid(["resnet_small", "resnet_large"], ShapeSuite("t", 1024, 32, "train"), sku=sku)
    assert [(w, g, _placements(p)) for w, g, p in got] == [(w, g, _placements(p)) for w, g, p in want]
    for prof in JSKUS[sku].profile_order:
        assert _placements(thomogeneous(prof, sku=sku)) == _placements(jhomogeneous(prof, sku=sku))


def _solos(cls, k, seed):
    rng = np.random.default_rng(seed)
    return [
        cls(name=f"job{i}", compute_s=float(rng.uniform(1e-3, 5e-2)), memory_s=float(rng.uniform(1e-3, 5e-2)),
            collective_s=float(rng.uniform(0, 1e-2)), latency_s=float(rng.uniform(1e-4, 4e-2)),
            peak_bytes_per_device=float(rng.uniform(1e9, 2e10)))
        for i in range(k)
    ]


@pytest.mark.parametrize("mode", ["naive", "mps"])
@pytest.mark.parametrize("k", [2, 4, 7])
def test_shared_mode_report_gives_the_same_floats(mode, k):
    for budget in ({}, {"hbm_budget_bytes": 80 * 10**9}):
        want = jshared(JMode(mode), _solos(JSolo, k, seed=k), **budget)
        got = tshared(TMode(mode), _solos(TSolo, k, seed=k), **budget)
        assert got.to_dict() == want.to_dict()
        assert got.effective_step_s == want.effective_step_s  # exact, not approx


def _char_db(sku, seed):
    """A seeded characterization DB over ``sku``'s profiles for two archs."""
    rng = np.random.default_rng(seed)
    db = {}
    for arch in ("small", "mid"):
        for prof in JSKUS[sku].profile_order:
            db[(arch, "t", prof)] = {
                "fits": bool(rng.uniform() > 0.2),
                "step_s": float(rng.uniform(0.5, 8.0)),
                "peak_bytes_per_device": float(rng.uniform(0.05, 0.5) * JSKUS[sku].slice_bytes),
            }
    return db


@pytest.mark.parametrize("sku", _sku_names())
def test_plan_placements_gives_the_same_plan(sku):
    plans = []
    for suite_cls, job_cls, cost_cls, plan in ((JSuite, jinstance.JobSpec, JCost, jplan),
                                              (ShapeSuite, tinstance.JobSpec, TCost, tplan)):
        suite = suite_cls("t", 1024, 32, "train")
        jobs = [job_cls(f"j{i}", "small" if i % 2 else "mid", suite, priority=i % 3) for i in range(5)]
        p = plan(jobs, cost_cls(_char_db(sku, seed=3), sku=sku))
        plans.append({
            "layout": _placements(p.layout), "assignments": {j: (a.profile, a.start) for j, a in p.assignments.items()},
            "step_s": dict(p.step_s), "unplaced": p.unplaced, "placed_weight": p.placed_weight,
            "kept_weight": p.kept_weight, "goodput": p.goodput, "flexibility": p.flexibility,
            "optimality": p.optimality, "gap": p.gap, "configs_evaluated": p.configs_evaluated, "score": p.score,
        })
    assert plans[1] == plans[0]
    assert plans[0]["assignments"]  # the plan placed something


def _records(cls, seed, n):
    rng = np.random.default_rng(seed)
    return [
        cls(job=f"w#{i}", arch="w", shape="t", profile="1g.10gb", start=i, chips=1, hbm_budget_bytes=10**10,
            peak_bytes_per_device=float(rng.uniform(1e9, 9e9)), fits=True, step_s=float(rng.uniform(0.01, 0.3)),
            compute_s=0.01, memory_s=0.02, collective_s=0.0, bound="memory", mfu=0.1,
            dcgm={m: float(rng.uniform()) for m in ("gract", "smact", "smocc_proxy", "drama")})
        for i in range(n)
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_give_the_same_floats(seed):
    want, got = _records(jinstance.InstanceRecord, seed, 7), _records(tinstance.InstanceRecord, seed, 7)
    full_j = dataclasses.replace(want[0], profile="7g.80gb")
    full_t = dataclasses.replace(got[0], profile="7g.80gb")
    assert tmetrics.collocation_speedup(got, full_t) == jmetrics.collocation_speedup(want, full_j)
    for samples in (45_000, 1_281_167):
        assert [tmetrics.epoch_time_s(r, samples, 32) for r in got] == [
            jmetrics.epoch_time_s(r, samples, 32) for r in want]
    assert tmetrics.throughput_jobs_per_s(got) == jmetrics.throughput_jobs_per_s(want)
    t = tmetrics.device_group_report("1g.10gb parallel", "w", got, sku="h100-80gb")
    j = jmetrics.device_group_report("1g.10gb parallel", "w", want, sku="h100-80gb")
    assert t.to_dict() == j.to_dict()
