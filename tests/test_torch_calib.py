"""The port's calibration loop against the reference's.

``calibrate --backend stub`` and ``--from-trace`` give byte-identical
documents from both packages. The kernels backend is rewritten for the card:
with each package's kernel measurement patched to one fixed reading, the two
calibrated documents are byte-identical too, so all that differs is what is
timed. On this machine, which has no CUDA, the backend refuses the card and
runs the kernels' plain versions when asked for the CPU.
"""
import ast
import inspect
import json

import pytest

import benchmarks.kernel_bench as jbench
from repro.core.calib import harness as jharness
from repro.core.calib import step_error_doc
from repro.launch import calibrate as jcal
from repro.launch.simulate import synthetic_char_db
from repro_torch.core import calib as tcalib_pkg
from repro_torch.core.calib import harness as tharness
from repro_torch.kernels import calibration as tbench
from repro_torch.launch import calibrate as tcal
from test_torch_core import as_reference

SKUS = ("a100-40gb", "a100-80gb", "h100-80gb", "a30-24gb")


def without(source: str, names=()) -> str:
    """``source`` less its module docstring and the top-level definitions
    called ``names``."""
    lines = source.splitlines(keepends=True)
    tree = ast.parse(source)
    drop = []
    for node in tree.body:
        is_doc = node is tree.body[0] and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
        if is_doc or getattr(node, "name", None) in names:
            first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
            drop.append((first - 1, node.end_lineno))
    for start, end in reversed(drop):
        del lines[start:end]
    return "".join(lines)


@pytest.mark.parametrize("ref,port,rewritten", [
    (jharness, tharness, ("KernelBackend", "make_backend")),
    (jcal, tcal, ("_epoch_s", "calibrate_sku", "main")),
    (__import__("repro.core.calib", fromlist=["x"]), tcalib_pkg, ()),
], ids=["harness", "calibrate", "calib_package"])
def test_the_rest_of_each_module_is_the_reference(ref, port, rewritten):
    """Imports, constants and every definition but the rewritten ones (and
    the module docstring, which says what the port's kernels backend times)."""
    got = as_reference(without(inspect.getsource(port), rewritten))
    want = without(inspect.getsource(ref), rewritten)
    assert got == want
    for name in rewritten:
        assert hasattr(port, name), name


def test_kernel_backend_keeps_the_references_arithmetic():
    want = inspect.getsource(jharness.KernelBackend._measure_full).splitlines()
    got = inspect.getsource(tharness.KernelBackend._measure_full).splitlines()
    first = next(i for i, line in enumerate(want) if "rec = dict(self.seed_db" in line)
    last = next(i for i, line in enumerate(want) if 'rec["max_err_vs_ref"]' in line)
    block = want[first:last + 1]
    assert len(block) >= 10 and "sku.step_latency_s" in "".join(block)
    at = got.index(block[0])
    assert got[at:at + len(block)] == block
    assert as_reference(inspect.getsource(tharness.KernelBackend.measure)) == inspect.getsource(
        jharness.KernelBackend.measure)


def _run(main, argv, out):
    assert main([*argv, "--out", str(out)]) == 0
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


@pytest.mark.parametrize("seed", [0, 1])
def test_stub_calibration_is_byte_identical_on_every_sku(tmp_path, seed):
    argv = ["--backend", "stub", "--seed", str(seed), "--skus", ",".join(SKUS)]
    want = _run(jcal.main, argv, tmp_path / "ref")
    got = _run(tcal.main, argv, tmp_path / "port")
    assert sorted(want) == ["_summary.json"] + sorted(f"calib_db__{s}.json" for s in SKUS)
    assert got == want


def test_from_trace_calibration_is_byte_identical(tmp_path):
    db = synthetic_char_db(sku="a100-40gb")
    samples = [
        {"arch": arch, "profile": prof, "measured_s": db[(arch, shape, prof)]["step_s"] * (1.1 + 0.05 * (i % 4)),
         "predicted_s": db[(arch, shape, prof)]["step_s"]}
        for i, (arch, shape, prof) in enumerate(sorted(db)) for _ in range(1 + i % 3)
    ]
    doc = tmp_path / "step_error.json"
    doc.write_text(json.dumps(step_error_doc(samples, meta={"seed": 0})))
    argv = ["--from-trace", str(doc), "--skus", "a100-40gb"]
    want = _run(jcal.main, argv, tmp_path / "ref")
    got = _run(tcal.main, argv, tmp_path / "port")
    assert got == want
    assert b'"refined"' in got["calib_db__a100-40gb.json"]


def test_calibration_shapes_are_the_references_but_for_the_cards_kernels():
    want = {k: dict(v) for k, v in jbench.CALIBRATION_SHAPES.items()}
    want["flash_attention"]["D"] = 64  # K1 takes head dims 64/128/160
    want["decode_attention"]["D"] = 64  # so does K4
    want["wkv6"]["K"] = 64  # K5 is built for K = V = 64
    for tiles in want.values():  # the Pallas tiles: the port's kernels choose their own
        for key in ("block_q", "block_k", "chunk"):
            tiles.pop(key, None)
    assert tbench.CALIBRATION_SHAPES == want
    assert tbench.CALIBRATION_KERNELS == jbench.CALIBRATION_KERNELS
    from repro.configs.registry import CONFIGS

    assert [tbench.calibration_kernel_for(a) for a in CONFIGS] == [jbench.calibration_kernel_for(a) for a in CONFIGS]


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "wkv6"])
def test_cpu_measurement_holds_the_plain_version(kernel):
    got = tbench.measure_calibration_kernel("granite-3-2b", device="cpu", kernel=kernel)
    assert set(got) == {"kernel", "wall_s", "max_err_vs_ref"}
    assert got["kernel"] == kernel and got["wall_s"] > 0
    assert got["max_err_vs_ref"] <= 2e-5
    with pytest.raises(KeyError, match="no calibration shape"):
        tbench.measure_calibration_kernel("granite-3-2b", device="cpu", kernel="conv")


def test_kernels_backend_algebra_is_the_references(tmp_path, monkeypatch):
    """Both packages' kernel measurement patched to one fixed reading: the
    calibrated h100-80gb and a100-40gb documents are byte-identical."""
    calls = {"ref": [], "port": []}

    def fixed(who):
        def measure(arch, **kw):
            calls[who].append((arch, kw))
            return {"kernel": "flash_attention", "wall_s": 3.7e-5, "max_err_vs_ref": 1.5e-3}
        return measure

    monkeypatch.setattr(jbench, "measure_calibration_kernel", fixed("ref"))
    monkeypatch.setattr(tbench, "measure_calibration_kernel", fixed("port"))
    argv = ["--backend", "kernels", "--skus", "h100-80gb,a100-40gb"]
    want = _run(jcal.main, argv, tmp_path / "ref")
    got = _run(tcal.main, [*argv, "--device", "cpu"], tmp_path / "port")
    assert got == want
    # one measurement per (arch, shape) of each SKU's probe plan, on the CPU as asked
    assert [a for a, _ in calls["port"]] == [a for a, _ in calls["ref"]]
    assert len(calls["port"]) == 16 and all(kw["device"] == "cpu" for _, kw in calls["port"])


def test_kernels_backend_on_the_cpu_writes_a_calibrated_db(tmp_path):
    from repro_torch.core.calib.records import CharDB

    out = tmp_path / "cal"
    assert tcal.main(["--backend", "kernels", "--device", "cpu", "--skus", "h100-80gb", "--out", str(out)]) == 0
    doc = json.loads((out / "calib_db__h100-80gb.json").read_text())
    assert doc["schema"] == "calib_char_db/v1"
    db = CharDB.loads((out / "calib_db__h100-80gb.json").read_text())
    counts = db.provenance_counts()
    assert counts["measured"] == 8 and counts["predicted"] == 8
    assert counts["refined"] == len(db) - 16 == 32
    full = [r for r in db.records.values() if r.provenance == "measured"]
    assert {r.profile for r in full} == {"7g.80gb"} and {r.source for r in full} == {"kernels"}


def test_kernels_backend_refuses_a_card_this_machine_has_not(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    assert tharness.KernelBackend.available("cpu")
    assert not tharness.KernelBackend.available("cuda") and not tharness.KernelBackend.available("mps")
    seed_db = synthetic_char_db(sku="h100-80gb")
    with pytest.raises(RuntimeError, match="'cuda'"):
        tharness.make_backend("kernels", seed_db, sku="h100-80gb", device="cuda")
    with pytest.raises(RuntimeError, match="'cuda:1'"):
        tcal.main(["--backend", "kernels", "--device", "cuda:1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="'cuda'"):
        tcal.main(["--backend", "kernels", "--out", str(tmp_path)])  # cuda is the default
    assert isinstance(tharness.make_backend("kernels", seed_db, sku="h100-80gb", device="cpu"),
                      tharness.KernelBackend)
