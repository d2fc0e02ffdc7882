"""The port stands alone: ``repro_torch`` imports, serves and trains with
``jax`` and the ``repro`` package made unimportable; and what it copied from
the reference (configs, the synthetic data stream, the host pipeline) is equal
to the original.
"""
import dataclasses
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_PROBE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "repro"):
    sys.modules[name] = None  # any `import jax...` / `import repro...` now raises ImportError

import torch
import repro_torch
import repro_torch.configs.base
import repro_torch.configs.registry
import repro_torch.checkpoint.store
import repro_torch.convert
import repro_torch.core
import repro_torch.core.calib
import repro_torch.core.calib.fit
import repro_torch.core.calib.harness
import repro_torch.core.calib.online
import repro_torch.core.calib.records
import repro_torch.core.cluster
import repro_torch.core.collocation
import repro_torch.core.device
import repro_torch.core.elastic
import repro_torch.core.events
import repro_torch.core.forecast
import repro_torch.core.forecast.estimator
import repro_torch.core.forecast.policy
import repro_torch.core.gang
import repro_torch.core.gang.comms
import repro_torch.core.gang.parallelism
import repro_torch.core.gang.placement
import repro_torch.core.instance
import repro_torch.core.interference
import repro_torch.core.metrics
import repro_torch.core.obs
import repro_torch.core.obs.perfetto
import repro_torch.core.obs.recorder
import repro_torch.core.partitioner
import repro_torch.core.planner
import repro_torch.core.planner.costmodel
import repro_torch.core.planner.enumerator
import repro_torch.core.planner.optimizer
import repro_torch.core.profiles
import repro_torch.core.queueing
import repro_torch.core.sharing
import repro_torch.core.slice_unit
import repro_torch.core.workload
import repro_torch.data.pipeline
import repro_torch.data.synthetic
import repro_torch.kernels._build
import repro_torch.kernels.calibration
import repro_torch.kernels.decode_attention
import repro_torch.kernels.flash_attention
import repro_torch.kernels.ops
import repro_torch.kernels.ref
import repro_torch.kernels.rwkv6_scan
import repro_torch.launch.collocate
import repro_torch.launch.calibrate
import repro_torch.launch.lowering
import repro_torch.launch.simulate
import repro_torch.launch.traces
import repro_torch.launch.train
import repro_torch.models.attention
import repro_torch.models.losses
import repro_torch.models.encdec
import repro_torch.models.mamba2
import repro_torch.models.model_api
import repro_torch.models.module
import repro_torch.models.moe
import repro_torch.models.resnet
import repro_torch.models.rwkv6
import repro_torch.models.transformer
import repro_torch.optim.adamw
import repro_torch.runtime.serve_step
import repro_torch.runtime.train_step
import repro_torch.sharding.plan
import repro_torch.telemetry.constants
import repro_torch.telemetry.counts
import repro_torch.telemetry.roofline

# importing built nothing and needs no compiler
from repro_torch.kernels import _build
assert _build.n_compiles == 0
assert len(_build.sources()) == 4

# and the slice runs end to end on the CPU
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.runtime.serve_step import greedy_generate
from repro_torch.sharding.plan import make_plan

cfg = get_config("granite-3-2b").reduced()
model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), "cpu")
prompt = torch.from_numpy(synthetic.token_batch(cfg.vocab, 2, 8, seed=7)["tokens"])
out = greedy_generate(model, params, prompt, 3, make_plan(cfg, None))
assert out.shape == (2, 3)
for arch in ("rwkv6-1.6b", "olmoe-1b-7b", "zamba2-7b"):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    out = greedy_generate(model, params, prompt, 3, make_plan(cfg, None))
    assert out.shape == (2, 3)

# and trains, through the launcher, with a checkpoint to resume from
import tempfile
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as tmp:
    argv = ["--arch", "granite-3-2b", "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
            "--warmup", "1", "--device", "cpu", "--ckpt-dir", tmp]
    result = train.run(train.build_argparser().parse_args(argv))
    assert result["steps"] == 3 and result["final_loss"] == result["final_loss"]
    assert train.run(train.build_argparser().parse_args(argv))["steps"] == 0  # resumed at the end
    argv = ["--arch", "resnet_small", "--reduced", "--steps", "2", "--batch", "2", "--warmup", "1",
            "--device", "cpu"]
    assert train.run(train.build_argparser().parse_args(argv))["steps"] == 2
    # and characterizes a workload of the paper's grid
    from repro_torch.launch import collocate
    assert collocate.main(["--workloads", "resnet_small", "--device", "cpu", "--reduced", "--out", tmp]) == 0
    # and simulates a fleet, and calibrates the char DB from the kernels' plain versions
    from repro_torch.launch import calibrate, simulate
    assert simulate.main(["--steps", "6", "--scenarios", "train_serve_mix", "--policies", "best",
                          "--out", tmp + "/sim"]) == 0
    assert calibrate.main(["--backend", "kernels", "--device", "cpu", "--skus", "h100-80gb",
                           "--out", tmp + "/calib"]) == 0
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
print("PORT-STANDS-ALONE")
"""


def test_port_imports_and_serves_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert "PORT-STANDS-ALONE" in proc.stdout


def test_no_source_of_the_port_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[. ])", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("*_torch.py"))
    assert len(files) > 20
    hits = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert hits == []


def test_configs_equal_the_reference_field_by_field():
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg

    assert list(treg.CONFIGS) == list(jreg.CONFIGS)
    assert list(treg.ASSIGNED) == list(jreg.ASSIGNED)
    for name, want in jreg.CONFIGS.items():
        got = treg.CONFIGS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced()), name
        assert (got.padded_vocab, got.resolved_head_dim, got.q_groups) == (
            want.padded_vocab, want.resolved_head_dim, want.q_groups)
    assert treg.dryrun_grid() == jreg.dryrun_grid()
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("seed,epoch,step", [(0, 0, 0), (7, 0, 0), (3, 2, 11)])
def test_token_batch_gives_the_same_bytes(seed, epoch, step):
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn

    extras = {"patches": ((2, 3, 8), "bfloat16")}
    want = jsyn.token_batch(49155, 4, 33, seed=seed, epoch=epoch, step=step, extras=extras)
    got = tsyn.token_batch(49155, 4, 33, seed=seed, epoch=epoch, step=step, extras=extras)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes(), key


def test_batch_for_gives_the_same_bytes():
    from repro.configs.registry import get_config as jget
    from repro.configs.base import ShapeSuite as JSuite
    from repro.data import synthetic as jsyn
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as tsyn

    for arch in ("granite-3-2b", "llava-next-34b", "resnet_small"):
        want = jsyn.batch_for(jget(arch).reduced(), JSuite("t", 16, 2, "train"), seed=5, step=3)
        got = tsyn.batch_for(get_config(arch).reduced(), ShapeSuite("t", 16, 2, "train"), seed=5, step=3)
        assert set(got) == set(want)
        for key in want:
            assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), (arch, key)


def test_host_pipeline_is_a_copy_of_the_reference():
    """The class body is the reference's line for line, and both give the same stream."""
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe

    assert inspect.getsource(tpipe.HostPipeline) == inspect.getsource(jpipe.HostPipeline)

    def source(step):
        return {"x": np.full((3,), step, dtype=np.int64)}

    streams = []
    for mod in (jpipe, tpipe):
        with mod.HostPipeline(source, workers=3, max_queue_size=2, start_step=5) as p:
            streams.append([int(p.get()["x"][0]) for _ in range(12)])
            assert set(p.stats()) == {"batches", "input_wait_s", "input_wait_per_batch_ms", "workers",
                                      "max_queue_size"}
    assert streams[0] == streams[1] == list(range(5, 17))
