"""The port's collocation characterization end to end on the CPU (reduced trio,
batch 4), read by the reference's reports; and the op counts it prices the
roofline with, against the reference's count of the same step's program.
"""
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

# benchmarks/ lies at the repo root, which is on sys.path only under `python -m pytest`
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common  # noqa: E402
from benchmarks import report  # noqa: E402
from repro.configs.base import ShapeSuite as JSuite  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.collocation import paper_experiment_grid as jgrid  # noqa: E402
from repro.models.model_api import build_model as jbuild_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_step as jts  # noqa: E402
from repro.telemetry import hlo as jhlo  # noqa: E402
from repro_torch.configs.base import ShapeSuite  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import interference  # noqa: E402
from repro_torch.core.device import get_sku  # noqa: E402
from repro_torch.core.instance import InstanceRecord  # noqa: E402
from repro_torch.core.partitioner import InstanceDevice, partition, verify_disjoint  # noqa: E402
from repro_torch.core.profiles import Placement  # noqa: E402
from repro_torch.launch import collocate  # noqa: E402
from repro_torch.launch.lowering import build_cell  # noqa: E402
from repro_torch.telemetry.counts import OpLog, count_step  # noqa: E402

TRIO = ("resnet_small", "resnet_medium", "resnet_large")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("collocation")
    rc = collocate.main(["--device", "cpu", "--reduced", "--out", str(out)])
    assert rc == 0
    return out


def _cells(out):
    return {f.name: json.loads(f.read_text()) for f in sorted(out.glob("*.json")) if not f.name.startswith("_")}


def test_every_cell_is_ok_and_named_by_the_reference_rule(artifacts):
    """File names: the reference's label rule (collocate.py:97, :140) over its
    own grid on the h100-80gb tree, and its shared-mode cells."""
    want = {"_summary.json"}
    for w in TRIO:
        for _, group, _ in jgrid([w], JSuite("t", 1024, 32, "train"), sku="h100-80gb"):
            want.add(f"{w}__{group.replace(' ', '_').replace('.', '_')}.json")
        want |= {f"{w}__{m}_x{k}.json" for m in ("naive", "mps") for k in (2, 4, 7)}
    assert {f.name for f in artifacts.iterdir()} == want
    summary = json.loads((artifacts / "_summary.json").read_text())
    assert summary == {"cells": len(want) - 1, "failures": 0}
    cells = _cells(artifacts)
    assert all(c["status"] == "OK" for c in cells.values())
    assert "resnet_small__7g_80gb_one.json" in cells  # the card's full profile, not the A100's 7g.40gb


def test_cells_carry_the_reference_schema_and_what_was_measured(artifacts):
    fields = set(InstanceRecord.__dataclass_fields__)
    for name, c in _cells(artifacts).items():
        assert all(set(r) == fields for r in c["records"]), name
        for r in c["records"]:
            InstanceRecord(**r)
            assert r["hlo_fingerprint"] and r["step_s"] > 0, name
        # on the CPU the step and the op trace are measured; the peak is not
        if c["mode"] == "solo":
            assert c["measured"] == ["step_s", "hlo_fingerprint"], name
        else:
            assert c["measured"] == ["hlo_fingerprint"], name
        if c["mode"] == "mig":
            assert c["isolation"]["disjoint"] and c["isolation"]["programs_identical"], name
            assert c["isolation"]["collectives_contained"], name


def test_solo_step_is_measured_and_the_shared_cells_keep_it(artifacts):
    cells = _cells(artifacts)
    for w in TRIO:
        solo = cells[f"{w}__non-MIG.json"]["records"][0]
        mig = cells[f"{w}__1g_10gb_one.json"]["records"][0]
        assert mig["hlo_fingerprint"] == solo["hlo_fingerprint"]
        # a MIG step is the roofline on 1/8 of the card (compute at 1/8 and
        # the discount of 1 compute slice for 1 memory unit (1.0), memory at
        # 1/8) plus the solo's measured step beyond its roofline, as the
        # shared cells split it
        latency = collocate.host_latency_s(solo)
        assert latency > 0
        busy = max(mig["compute_s"], mig["memory_s"], mig["collective_s"])
        assert mig["step_s"] == pytest.approx(busy + latency, rel=1e-12)
        assert mig["memory_s"] == pytest.approx(8 * solo["memory_s"], rel=1e-12)
        assert mig["compute_s"] == pytest.approx(8 * solo["compute_s"], rel=1e-12)
        full = cells[f"{w}__7g_80gb_one.json"]["records"][0]
        assert solo["step_s"] <= full["step_s"] < mig["step_s"]
        # the DCGM analogues are over each record's own step
        for r in (solo, mig):
            assert r["dcgm"]["smact"] == pytest.approx(r["compute_s"] / r["step_s"], rel=1e-12)
            assert r["dcgm"]["drama"] == pytest.approx(r["memory_s"] / r["step_s"], rel=1e-12)
        for k in (2, 4, 7):
            naive = cells[f"{w}__naive_x{k}.json"]
            assert naive["solo_step_s"] == pytest.approx(solo["step_s"], rel=1e-12)
            assert naive["records"][0]["step_s"] == pytest.approx(1.07 * k * solo["step_s"], rel=1e-12)
            assert naive["shared"]["hbm_budget_bytes"] == solo["hbm_budget_bytes"]


def test_the_reference_reports_read_the_artifacts(artifacts, monkeypatch):
    monkeypatch.setattr(benchmarks.common, "COLLOCATION_DIR", artifacts)
    table = report.fmt_collocate()
    rows = [line for line in table.splitlines() if line.startswith("| resnet")]
    assert len(rows) == len(_cells(artifacts))
    assert any("| 7g.80gb one | mig |" in r for r in rows)
    modes = report.fmt_modes()
    mode_rows = [line for line in modes.splitlines() if line.startswith("| resnet")]
    assert len(mode_rows) == 3 * 2 * 3  # workloads x (naive, mps) x k
    assert "resnet_small | naive | 7 |" in modes


def test_planted_fingerprint_breaks_program_equivalence(artifacts):
    recs = [InstanceRecord(**r) for r in _cells(artifacts)["resnet_small__1g_10gb_parallel.json"]["records"]]
    assert len(recs) == 7 and interference.check_program_equivalence(recs) == (True, "")
    recs[3].hlo_fingerprint = "0" * 16
    ok, why = interference.check_program_equivalence(recs)
    assert not ok and "fingerprint" in why


def test_instances_are_disjoint_memory_units_of_the_card():
    sku = get_sku("h100-80gb")
    insts = partition(CPU, [Placement("1g.20gb", s) for s in (0, 2, 4, 6)], sku=sku)
    assert [i.units for i in insts] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert len({i.hbm_budget_bytes for i in insts}) == 1
    verify_disjoint(insts)
    assert interference.check_disjoint(insts) == (True, "")
    overlap = insts + [InstanceDevice(Placement("1g.10gb", 3), CPU, (3, 4), insts[0].hbm_budget_bytes // 2)]
    with pytest.raises(AssertionError, match="memory unit 3"):
        verify_disjoint(overlap)
    assert not interference.check_disjoint(overlap)[0]
    with pytest.raises(ValueError, match="invalid MIG layout"):
        partition(CPU, [Placement("4g.40gb", 0), Placement("3g.40gb", 4)], sku=sku)


def test_collective_containment_reads_the_counted_groups():
    assert interference.check_collective_containment({"groups": []}, [0], 1) == (True, "")
    ok, why = interference.check_collective_containment({"groups": [[0, 1]]}, [0], 1)
    assert not ok and "exceeds instance size 1" in why


def test_collocate_refuses_a_workload_beyond_the_trio(tmp_path):
    """A key beyond the trio, once refused, is characterized at the
    reference's ``LM_SUITE`` (train_4k), its step accumulated to the suite's
    batch; ``tests/test_torch_collocate_lm.py`` holds every family."""
    rc = collocate.main(["--workloads", "granite-3-2b", "--device", "cpu", "--reduced", "--out", str(tmp_path)])
    assert rc == 0
    solo = json.loads((tmp_path / "granite-3-2b__non-MIG.json").read_text())
    assert solo["status"] == "OK" and solo["suite"] == "train_4k" and solo["samples_per_epoch"] == 1_281_167
    assert solo["records"][0]["shape"] == "train_4k" and solo["measured"] == ["step_s", "hlo_fingerprint"]


def test_counts_of_one_matmul_and_one_conv_are_2mnk():
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 7, generator=gen), torch.randn(7, 3, generator=gen)
    _, c = count_step(lambda: a @ b, (a, b))
    assert c.flops == 2 * 5 * 3 * 7
    # the product's operands and result, plus the step's inputs read once
    assert c.hbm_bytes == 4 * (5 * 7 + 7 * 3 + 5 * 3) + 4 * (5 * 7 + 7 * 3)
    assert c.product_dtype == torch.float32
    assert c.collectives["n_collective_sites"] == 0 and "no c10d op" in c.collectives["detail"]
    x, w = torch.randn(2, 4, 9, 9, generator=gen), torch.randn(6, 4, 3, 3, generator=gen)
    _, c = count_step(lambda: F.conv2d(x, w, stride=2), (x, w))
    M, N, K = 2 * 4 * 4, 6, 4 * 3 * 3  # output positions, output channels, window
    assert c.flops == 2 * M * N * K
    _, again = count_step(lambda: F.conv2d(x, w, stride=2), (x, w))
    _, other = count_step(lambda: F.conv2d(x, w, stride=1), (x, w))
    assert again.fingerprint == c.fingerprint != other.fingerprint


def _reference_step_text(cfg, suite):
    model = jbuild_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jitted, *_ = jts.jit_train_step(model, mesh, suite, jadamw.AdamWConfig())
    state = jax.eval_shape(lambda k: jts.init_train_state(model, k, jadamw.AdamWConfig()), jax.random.key(0))
    return jitted.lower(state, model.input_specs(suite)).compile().as_text()


def _products_without_dilation_zeros(text):
    """The reference's dot and convolution FLOPs (``hlo_flops_bytes``'s own
    per-op count), with a convolution whose input XLA dilates (the gradient
    of a strided convolution) counted over its real inputs: the reference
    counts 2·out·K_window, which multiplies the inserted zeros too."""
    total = 0.0
    for lines in jhlo._split_computations(text).values():
        symtab = {om.group("name"): om.group("type") for om in map(jhlo._OP_RE.match, lines) if om}
        for line in lines:
            om = jhlo._OP_RE.match(line)
            if om and om.group("op") in ("dot", "convolution"):
                dil = re.search(r"lhs_dilate=(\d+)x(\d+)", line)
                total += jhlo._op_flops(om, line, symtab) / (int(dil[1]) * int(dil[2]) if dil else 1)
    return total


#: the reduced trio's step, the port's HBM bytes (telemetry/hlo.py's traffic
#: model, what core/instance.py records) over the reference's
#: ``hlo_flops_bytes`` of its compiled program. Read: 1.441 (the three reduced
#: configs are one network). The ops that differ: the port counts
#: BatchNorm's forward and backward and the other reductions (17.2 MB of the
#: 45.8), which XLA:CPU fuses with their producers, so that no ``reduce`` is
#: left at the reference program's top level to count; and it counts one
#: ``convolution_backward`` (reads x, dy and w once) where the reference's
#: program has two convolutions that each read dy (24.9 MB of products
#: against 29.1). Both count the program's inputs once (2.7 MB).
BYTES_RATIO, BYTES_RATIO_TOL = 1.441, 0.05


def test_step_bytes_match_the_reference_traffic_model():
    jcfg = jget_config("resnet_small").reduced()
    ref = jhlo.hlo_flops_bytes(_reference_step_text(jcfg, JSuite("t", jcfg.img_size**2, 4, "train")))
    cfg = get_config("resnet_small").reduced()
    _, state, batch, step = build_cell(cfg, ShapeSuite("t", cfg.img_size**2, 4, "train"), CPU)
    log = OpLog()
    with log:
        step(state, batch)
    _, counts = count_step(lambda: step(state, batch), inputs=(state, batch))
    assert abs(counts.hbm_bytes / ref["bytes"] - BYTES_RATIO) <= BYTES_RATIO_TOL, (counts.hbm_bytes, ref["bytes"])
    # the fused model, below every op's inputs and outputs added up
    assert counts.hbm_bytes < sum(i + o for _, i, o, _ in log.trace)


def test_step_counts_match_the_reference_program():
    """The reduced resnet_small train step, counted by the port, against the
    reference's count of the same step's compiled program on the CPU."""
    jcfg = jget_config("resnet_small").reduced()
    text = _reference_step_text(jcfg, JSuite("t", jcfg.img_size**2, 4, "train"))
    ref = jhlo.hlo_flops_bytes(text)
    cfg = get_config("resnet_small").reduced()
    _, state, batch, step = build_cell(cfg, ShapeSuite("t", cfg.img_size**2, 4, "train"), CPU)
    _, counts = count_step(lambda: step(state, batch), (state, batch))
    assert abs(counts.flops / _products_without_dilation_zeros(text) - 1) <= 0.01
    assert counts.flops < ref["flops"]  # the reference's total counts the zeros
