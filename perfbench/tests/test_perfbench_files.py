"""BENCHMARK.json and the files it names: every cell's configuration and
traffic exist and agree, every metric has a reader, every name and unit is
made of the allowed characters, and each configuration's model section
states what its program fields build."""
import json
import re

import pytest

from harness import spec as specs

BENCH = specs.benchmark()
NAME = specs.NAME
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = specs.load(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == entry[key]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    assert set(spec["limits"]) == {"loss", "grad", "update"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = specs.read_json(specs.ROOT / entry["file"])
    assert entry["file"] == f"perfbench/configs/{config}.json"
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])


def test_names_and_units():
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[sec]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert (specs.BENCH_DIR / "metrics" / f"{metric}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_a_rate_and_a_layer(cell):
    e2e = {m["name"] for m in specs.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = specs.metrics_for(BENCH, cell, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_program_fields_build_the_stated_model(config):
    """The program's configuration, as the cell builds it, has the widths
    and depth that the model section (the reference's) states."""
    from harness.job import program_config

    data = specs.read_json(specs.BENCH_DIR / "configs" / f"{config}.json")
    cfg, m = program_config({"config_data": data}), data["model"]
    if m["family"] == "dense":
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab,
               cfg.rope_theta, cfg.tie_embeddings)
        assert got == (m["layers"], m["d_model"], m["heads"], m["kv_heads"], m["head_dim"], m["d_ff"], m["vocab"],
                       m["rope_theta"], True)
        assert (data["hidden_size"], data["num_hidden_layers"], data["intermediate_size"]) == (
            m["d_model"], m["layers"], m["d_ff"])
    else:
        assert (list(cfg.stages), cfg.img_size, cfg.n_classes, cfg.base_width) == (
            m["stages"], m["image_size"], m["classes"], m["base_width"])
