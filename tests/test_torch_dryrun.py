"""The port's multi-pod dry-run on the CPU: per-device counts on a fake
process group, one full-size cell lowered on fake tensors, the SKIP and FAIL
records, the reference's report over the port's records, and the FLOPs of a
reduced step at a 1 x 1 mesh against the reference's count of its program.
The collectives' group sizes are held on a real 2 x 4 gloo mesh: this file
run as a script spawns its eight ranks over a ``FileStore``, as
``test_torch_mesh_ranks.py`` does.

Each test that starts a fake process group (``lowering.fake_world``) destroys
it before it ends, so the tests share a worker with others.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common  # noqa: E402
from benchmarks import report  # noqa: E402
from repro.configs.base import ShapeSuite as JSuite  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model_api import build_model as jbuild_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_step as jts  # noqa: E402
from repro.telemetry import hlo as jhlo  # noqa: E402
from repro_torch.configs.base import ShapeSuite  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun, lowering  # noqa: E402
from repro_torch.launch.mesh import make_mesh_shape  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.runtime import train_step as ts  # noqa: E402
from repro_torch.sharding.plan import AbstractMesh, make_plan, param_pspecs, validate_pspecs  # noqa: E402
from repro_torch.telemetry.counts import count_step  # noqa: E402

#: the product of point 2 of the dry-run's design: a (256, 4096, 8192) batch
#: sharded over data times an (8192, 28672) weight sharded over model
BATCH, SEQ, D, F = 256, 4096, 8192, 28672
GLOBAL_FLOPS = 2.0 * BATCH * SEQ * D * F  # 492.6 TFLOP
#: the reduced granite step's FLOPs at a 1 x 1 mesh against the reference's
#: ``hlo_flops_bytes`` of its program, (port / reference - 1). Read: +1.39%
#: with remat off, +1.14% with it on: the port's plain backward of attention
#: recomputes the scores from the saved log-sum-exp (the kernels' own
#: algorithm), one product more a layer than autodiff of the reference's
TOL_FLOPS = 0.02


def _fake(shape, placements, mesh):
    from torch.distributed.tensor import empty

    return empty(shape, dtype=torch.bfloat16, device_mesh=mesh, placements=placements)


def test_flops_are_counted_on_each_devices_shards():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with lowering.fake_world(256):
        mesh = make_mesh_shape((16, 16), ("data", "model"), device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = _fake((BATCH, SEQ, D), [Shard(0), Replicate()], mesh)
            w = _fake((D, F), [Replicate(), Shard(1)], mesh)
            _, sharded = count_step(lambda: x @ w, (x, w))
            xr = _fake((2, 64, D), [Replicate(), Replicate()], mesh)
            _, replicated = count_step(lambda: xr @ w.redistribute(mesh, [Replicate(), Replicate()]), (xr, w))
    assert sharded.flops == GLOBAL_FLOPS / 256  # 1.92 TFLOP a device, not 492.6
    assert sharded.collectives["n_collective_sites"] == 0
    # a replicated product: every rank computes it whole; the gather of the
    # weight over model is one all-gather over that axis's 16 ranks
    assert replicated.flops == 2.0 * 2 * 64 * D * F
    (op,) = replicated.collectives["top_ops"]
    assert (op["kind"], op["group"]) == ("all-gather", 16)


def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(sizes[a] for a in names)
    return n * itemsize


@pytest.fixture(scope="module")
def granite_cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("granite-3-2b", "train_4k", "single", out)
    return rec, out


def test_full_size_cell_lowers_on_fake_tensors(granite_cell):
    rec, out = granite_cell
    assert rec["status"] == "OK" and rec["cell"] == "granite-3-2b__train_4k__single"
    assert json.loads((out / "granite-3-2b__train_4k__single.json").read_text()) == rec
    assert rec["xla_cost_analysis"] is None and rec["t_compile_s"] is None
    r = rec["roofline"]
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0 and r["wire_bytes_per_device"] > 0
    # argument bytes: the local shards of the spec rules, params in their
    # type, AdamW's m and v in f32, the step counter, the batch over data
    cfg = get_config("granite-3-2b")
    model = build_model(cfg)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = mesh.shape
    shapes = ts.param_shapes(model)
    specs = validate_pspecs(shapes, param_pspecs(shapes), mesh)
    want = sum(_local_bytes(p.shape, s, sizes, p.element_size() + 4 + 4)
               for p, s in zip(tree_leaves(shapes), tree_leaves(specs)))
    plan = make_plan(cfg, mesh, dryrun.SHAPES_BY_NAME["train_4k"])
    want += 4  # the step counter, a 0-d int32 every rank holds
    for shape, dtype in model.input_specs(dryrun.SHAPES_BY_NAME["train_4k"]).values():
        want += _local_bytes(shape, plan.spec("tokens"), sizes, torch.empty((), dtype=dtype).element_size())
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] == want
    # the state is updated in place: the outputs alias the arguments but for the metrics
    assert mem["alias_bytes"] == want - 2 * 16 * 4096 * 4 - 4
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
                                           + mem["temp_bytes"])
    # no rank holds a buffer of the global logits' shape (the loss's gather
    # scatters its gradient on the local shard): the temporaries, the plain
    # attention's score tensors at their peak, stay below one such buffer
    assert mem["temp_bytes"] < 256 * 4096 * cfg.padded_vocab * 4


def _broken_lowering(*_args, **_kwargs):
    raise RuntimeError("planted lowering fault")


def test_skip_and_fail_cells(tmp_path, monkeypatch):
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k", "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "granite-3-2b__long_500k__single.json").read_text())
    assert skip == {"cell": "granite-3-2b__long_500k__single", "status": "SKIP",
                    "reason": "full-attention arch: O(S^2) at 500k — skipped per DESIGN.md"}
    # the rwkv family lowers on both meshes (its decode step on each rank's batch rows and heads)
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--mesh", "both",
                        "--out", str(tmp_path)]) == 0
    for mesh in ("single", "multi"):
        ok = json.loads((tmp_path / f"rwkv6-1.6b__decode_32k__{mesh}.json").read_text())
        assert ok["status"] == "OK" and ok["roofline"]["chips"] == (256 if mesh == "single" else 512)
    # a cell whose lowering raises is recorded FAIL with its error, and the command exits 1
    monkeypatch.setattr(dryrun, "lower_cell", _broken_lowering)
    assert dryrun.main(["--arch", "zamba2-7b", "--shape", "decode_32k", "--mesh", "both",
                        "--out", str(tmp_path)]) == 1
    for mesh in ("single", "multi"):
        fail = json.loads((tmp_path / f"zamba2-7b__decode_32k__{mesh}.json").read_text())
        assert fail["status"] == "FAIL" and "planted lowering fault" in fail["error"]
    import torch.distributed as tdist

    assert not tdist.is_initialized()  # each cell's fake group is gone, a failed one's too


def test_a_prefills_new_cache_holds_only_each_ranks_shard():
    """The prefill makes its cache through ``plan.new``: on a fake 16 x 16
    mesh each rank allocates 1/256 of deepseek's (L, B, S, KVH, D) caches at
    prefill_32k. A whole cache brought to the spec by ``plan.act`` stayed
    allocated under its shard's view: 224 GiB a rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import cache_spec

    cfg = get_config("deepseek-moe-16b")
    suite = ShapeSuite("prefill_32k", 32768, 32, "prefill")
    with lowering.fake_world(256):
        mesh = make_mesh_shape((16, 16), ("data", "model"), device="cpu")
        plan = make_plan(cfg, mesh, suite)
        total = 0
        with FakeTensorMode(allow_non_fake_inputs=True):
            for shape, dtype in cache_spec(cfg, suite.global_batch, suite.seq_len).values():
                whole = math.prod(shape) * dtype.itemsize
                total += whole
                for init in ("zeros", "empty"):
                    c = plan.new(shape, dtype, "cache", "cpu", init=init)
                    assert tuple(c.shape) == shape and c.to_local().untyped_storage().nbytes() == whole // 256
    assert total == 224 * 2**30  # k and v


def test_cells_of_two_archs_in_one_process(tmp_path):
    """deepseek's top-6 router and then olmoe's top-8 on the same layout: the
    second lowering must not read the first's cached output shapes (DTensor's
    cache key leaves ``topk``'s k out)."""
    for arch, top_k in (("deepseek-moe-16b", 6), ("olmoe-1b-7b", 8)):
        assert get_config(arch).moe.top_k == top_k
        assert dryrun.run_cell(arch, "decode_32k", "single", tmp_path)["status"] == "OK"


def test_report_renders_the_ports_records(granite_cell, tmp_path, monkeypatch):
    _, out = granite_cell
    dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k", "--out", str(out)])
    monkeypatch.setattr(dryrun, "lower_cell", _broken_lowering)
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "train_4k", "--out", str(out)])
    monkeypatch.setattr(benchmarks.common, "DRYRUN_DIR", out)
    text = report.fmt_dryrun()
    assert text.startswith("1 compiled cells + 1 documented skips")
    rows = {line.split("|")[1].strip() + " " + line.split("|")[2].strip(): line for line in text.splitlines()
            if line.startswith("| ") and "---" not in line}
    r = json.loads((out / "granite-3-2b__train_4k__single.json").read_text())["roofline"]
    assert f"{r['compute_s']:.4f}" in rows["granite-3-2b train_4k"]
    assert "SKIP" in rows["granite-3-2b long_500k"] and "FAIL" in rows["rwkv6-1.6b train_4k"]


def _reference_flops(cfg, suite) -> float:
    model = jbuild_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jitted, *_ = jts.jit_train_step(model, mesh, suite, jadamw.AdamWConfig())
    state = jax.eval_shape(lambda k: jts.init_train_state(model, k, jadamw.AdamWConfig()), jax.random.key(0))
    return jhlo.hlo_flops_bytes(jitted.lower(state, model.input_specs(suite)).compile().as_text())["flops"]


@pytest.mark.parametrize("remat", [False, True])
def test_flops_at_one_device_match_the_reference_program(remat, monkeypatch):
    """``lower_cell`` at a fake 1 x 1 mesh, reduced granite (the registry's
    config swapped for its reduced form), against the reference's count of
    its jitted step on the CPU."""
    cfg = get_config("granite-3-2b").reduced(remat=remat)
    want = _reference_flops(jget_config("granite-3-2b").reduced(remat=remat), JSuite("t", 32, 4, "train"))
    monkeypatch.setattr(lowering, "get_config", lambda arch: cfg)
    with lowering.fake_world(1):
        mesh = make_mesh_shape((1, 1), ("data", "model"), device="cpu")
        _, _, lowered = lowering.lower_cell("granite-3-2b", ShapeSuite("t", 32, 4, "train"), mesh)
    assert abs(lowered.flops / want - 1) <= TOL_FLOPS, (lowered.flops, want)
    assert lowered.flops > want  # the one product more of the plain backward


def test_lowered_fingerprint_is_the_real_steps(tmp_path, monkeypatch):
    """The fake 1 x 1 lowering traces the program a real one-rank group runs:
    the same op sequence (fingerprint) and FLOPs as ``jit_train_step`` run on
    real tensors under the counters (reduced granite, remat on). On the card
    ``chip_smoke.py`` holds the full-size step the same way."""
    import torch.distributed as tdist

    from repro_torch.data import synthetic
    from repro_torch.optim import adamw
    from repro_torch.sharding import dist

    cfg = get_config("granite-3-2b").reduced(remat=True)
    suite = ShapeSuite("t", 32, 4, "train")
    monkeypatch.setattr(lowering, "get_config", lambda arch: cfg)
    with lowering.fake_world(1):
        _, _, lowered = lowering.lower_cell("granite-3-2b", suite, make_mesh_shape((1, 1), ("data", "model"),
                                                                                     device="cpu"))
    tdist.init_process_group("gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh_shape((1, 1), ("data", "model"), device="cpu")
        model, opt = build_model(cfg), adamw.AdamWConfig()
        step, st_sh, b_sh, _ = ts.jit_train_step(model, mesh, suite, opt)
        state = dist.distribute(ts.init_train_state(model, torch.Generator().manual_seed(0), opt, "cpu"), st_sh)
        batch = dist.distribute({k: torch.from_numpy(np.asarray(v))
                                 for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}, b_sh)
        _, real = count_step(lambda: step(state, batch), inputs=(state, batch))
    finally:
        tdist.destroy_process_group()
    assert (lowered.fingerprint, lowered.flops, lowered.bytes) == (real.fingerprint, real.flops, real.hbm_bytes)


def _collectives_rank(rank: int, tmp: str) -> None:
    """All-reduces over each axis of a 2 x 4 mesh, and an even and an
    uneven all-to-all over ``model``, under the counters."""
    import torch.distributed as tdist
    from torch.distributed._functional_collectives import all_to_all_single
    from torch.distributed.tensor import DTensor, Partial, Replicate

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(tmp, "store"), 8), rank=rank, world_size=8)
    try:
        mesh = make_mesh_shape((2, 4), ("data", "model"), device="cpu")
        x = torch.ones(64, 32)  # R = 8,192 bytes
        found = {}
        for axis, pl in (("model", [Replicate(), Partial()]), ("data", [Partial(), Replicate()])):
            part = DTensor.from_local(x, mesh, pl, run_check=False)
            _, c = count_step(lambda: part.redistribute(mesh, [Replicate(), Replicate()]), part)
            found[axis] = c.collectives["top_ops"]
        _, c = count_step(lambda: tdist.all_reduce(x.clone(), group=mesh.get_group("model")), x)
        found["legacy"] = c.collectives["top_ops"]
        group = mesh.get_group("model")
        _, c = count_step(lambda: all_to_all_single(x, None, None, group).wait(), x)
        found["even"] = c.collectives["top_ops"]
        # rank t of model keeps 48 of its 64 rows and sends 16 to rank t ^ 1, none to the others
        t = mesh.get_local_rank("model")
        splits = [48 if j == t else 16 if j == t ^ 1 else 0 for j in range(4)]
        _, c = count_step(lambda: all_to_all_single(x, splits, splits, group).wait(), x)
        found["pair"] = c.collectives["top_ops"]
        if rank == 0:
            Path(tmp, "result.json").write_text(json.dumps(found))
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """Rank 0's ``top_ops`` of the collectives that ``_collectives_rank``
    runs on a 2 x 4 gloo mesh, this file run as a script."""
    tmp = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, __file__, str(tmp)], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((tmp / "result.json").read_text())


def test_a_collective_records_the_size_of_its_own_group(collectives):
    found = collectives
    R = 64 * 32 * 4
    for axis, group in (("model", 4), ("data", 2), ("legacy", 4)):
        (op,) = found[axis]
        assert (op["kind"], op["bytes"], op["group"]) == ("all-reduce", R, group), (axis, op)
        assert op["wire"] == 2 * R * (group - 1) / group, (axis, op)  # 2R·3/4 over model, 2R·1/2 over data


def test_an_all_to_all_is_priced_by_its_splits(collectives):
    """An all-to-all's wire bytes are what the rank sends to the others: an
    even one R·(n-1)/n, the reference's; one whose splits are zero outside
    a pair of ranks the rows it sends its partner (16 of its 64), where
    the even price would say 3/4 of them."""
    R = 64 * 32 * 4
    (even,) = collectives["even"]
    assert (even["kind"], even["bytes"], even["group"], even["wire"]) == ("all-to-all", R, 4, R * 3 / 4), even
    (pair,) = collectives["pair"]
    assert (pair["kind"], pair["bytes"], pair["group"], pair["wire"]) == ("all-to-all", R, 4, 16 * 32 * 4), pair


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(_collectives_rank, args=(sys.argv[1],), nprocs=8, join=True)
