"""The port's event-driven cluster simulator against the reference's.

The modules are copies (``tests/test_torch_core.py::COPIED``); this file
holds what is not a plain copy to the reference's source, and what the
copies compute: the seed-0 default grid, a small run of each opt-in
scenario family and a traced run give byte-identical artifacts from
``repro.launch.simulate`` and ``repro_torch.launch.simulate``, run on one
interpreter (one libm).
"""
import ast
import inspect

import pytest

from repro.launch import simulate as jsim
from repro_torch.launch import simulate as tsim
from test_torch_core import as_reference

# the block of the reference's ``main`` that sets an XLA flag before a
# measured --db rerun; the port has no XLA, and its ``main`` is the
# reference's with exactly this block taken out
BOOTSTRAP_BLOCK = """\
    if args.db:
        # parity with collocate.py for measured-DB reruns; kept out of
        # module scope so importing this module (tests, benchmarks) never
        # mutates XLA_FLAGS before an unrelated jax backend initializes
        from repro.launch.bootstrap import ensure_host_platform_devices

        ensure_host_platform_devices()
"""


def top_level_names(source: str) -> list:
    return [n.name for n in ast.parse(source).body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]


def test_simulate_is_the_reference_but_for_the_xla_bootstrap():
    want = inspect.getsource(jsim)
    got = as_reference(inspect.getsource(tsim))
    assert want.count(BOOTSTRAP_BLOCK) == 1
    assert got == want.replace(BOOTSTRAP_BLOCK, "")
    # every function and class but ``main`` is the reference's as it stands
    names = top_level_names(want)
    assert len(names) > 8 and "main" in names
    for name in names:
        if name != "main":
            assert as_reference(inspect.getsource(getattr(tsim, name))) == inspect.getsource(getattr(jsim, name)), name
    assert "ensure_host_platform_devices" not in inspect.getsource(tsim)


def test_core_exports_the_cluster_api():
    import repro.core as jcore
    import repro_torch.core as tcore

    names = ("Cluster", "ClusterJob", "ClusterReport", "DeviceState", "Event", "EventKind", "EventQueue",
             "AdmissionQueue")
    for name in names:
        port = getattr(tcore, name)
        assert port.__module__.startswith("repro_torch.core."), name
        assert port.__name__ == getattr(jcore, name).__name__
    assert {n for n in dir(jcore) if not n.startswith("_")} <= {n for n in dir(tcore) if not n.startswith("_")}


def _run_both(tmp_path, argv):
    """Run both CLIs with ``argv`` into two directories; their files and codes."""
    outs = []
    for name, main in (("ref", jsim.main), ("port", tsim.main)):
        out = tmp_path / name
        rc = main([*argv, "--out", str(out)])
        outs.append((rc, {p.name: p.read_bytes() for p in sorted(out.iterdir())}))
    return outs


def _assert_identical(tmp_path, argv):
    (rc_j, want), (rc_t, got) = _run_both(tmp_path, argv)
    assert rc_t == rc_j == 0
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return want


def test_default_grid_is_byte_identical(tmp_path):
    files = _assert_identical(tmp_path, ["--seed", "0"])
    # the default grid: 6 scenarios x 6 fleet policies, and the summary
    assert len(files) == len(jsim.SCENARIOS) * len(jsim.POLICIES) + 1 == 37
    assert b'"failures": 0' in files["_summary.json"]


# the planner fleet takes most of diurnal_serve's time (it re-plans the
# placement tree at every session wave); the default grid runs it on every
# other scenario
FAMILY_POLICIES = {"diurnal_serve": [p for p in jsim.POLICIES if p != "planner"]}


@pytest.mark.parametrize("family", [jsim.CITY_SCENARIOS, jsim.GANG_SCENARIOS, jsim.FORECAST_SCENARIOS],
                         ids=["city_scale", "gang_pipeline", "diurnal_serve"])
def test_opt_in_family_is_byte_identical(tmp_path, family):
    policies = FAMILY_POLICIES.get(",".join(family), jsim.POLICIES)
    files = _assert_identical(tmp_path, ["--seed", "1", "--steps", "12", "--scenarios", ",".join(family),
                                         "--policies", ",".join(policies)])
    assert len(files) == len(family) * len(policies) + 1
    assert b'"failures": 0' in files["_summary.json"]


def test_traced_run_and_its_exports_are_byte_identical(tmp_path):
    files = _assert_identical(tmp_path, ["--seed", "0", "--steps", "12", "--trace",
                                         "--scenarios", "train_serve_mix,diurnal_serve", "--policies", "best,forecast"])
    assert sum(n.startswith("_trace__") for n in files) == sum(n.startswith("_counters__") for n in files) == 4


def test_list_prints_the_same_registry(capsys):
    printed = []
    for main in (jsim.main, tsim.main):
        assert main(["--list"]) == 0
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    assert "diurnal_serve" in printed[0] and "h100-80gb" in printed[0]


@pytest.mark.parametrize("argv", [["--gang-world-size", "3"], ["--gang-parallelism", "tp3"],
                                  ["--scenarios", "no_such_scenario"], ["--policies", "nope"],
                                  ["--gang-world-size", "4", "--gang-parallelism", "tp2"],
                                  ["--db", "x", "--sku", "h100-80gb"], ["--trace-exporter", "perfetto"]],
                         ids=["world_size", "parallelism", "scenario", "policy", "mismatch", "db_sku", "exporter"])
def test_cli_errors_are_the_references(capsys, argv):
    """The same exit code and message as the reference, whatever argparse's
    wording of the day (the reference's own test of one of these expects an
    older wording)."""
    errs = []
    for main in (jsim.main, tsim.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert errs[1] == errs[0] and "error:" in errs[0]


def test_cluster_observe_step_feeds_the_calibrator_as_the_reference():
    """The online-calibration hook gives the same predictions in both packages."""
    from repro.core.calib import OnlineCalibrator as JCalib
    from repro.core.cluster import Cluster as JCluster
    from repro.core.instance import JobSpec as JJob
    from repro.core.sharing import CollocationMode as JMode
    from repro_torch.core import Cluster as TCluster
    from repro_torch.core.calib import OnlineCalibrator as TCalib
    from repro_torch.core.instance import JobSpec as TJob
    from repro_torch.core.sharing import CollocationMode as TMode

    got = []
    for sim, cluster, calib_cls, job, mode in ((jsim, JCluster, JCalib, JJob, JMode),
                                               (tsim, TCluster, TCalib, TJob, TMode)):
        calib = calib_cls()
        cl = cluster(sim.synthetic_char_db(), [("d0", mode.MIG)], calibrator=calib)
        spec = job("j0", "granite-3-2b", sim.SIM_SUITE)
        cl.submit(spec, 0.0, epochs=1)
        cl.run_until(0.0)
        dev = cl.devices["d0"]
        prof = dev.assignments["j0"].placement.profile
        base = dev.scheduler.predict_step(spec, prof)
        for i in range(30):
            cl.observe_step("j0", base * 1.3, at_s=0.001 * (i + 1))
        got.append((prof, base, dev.scheduler.predict_step(spec, prof), calib.snapshot()))
    assert got[1] == got[0]
