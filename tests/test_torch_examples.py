"""PyTorch port vs the JAX reference: the ``examples/*_torch.py`` twins of
quickstart, train_lm, the collocated sweep and elastic failover, on the CPU at
the reduced configs, and ``core.partitioner.partition_homogeneous``.

Each twin is loaded from its path and driven through ``main(argv)`` or its
functions. Of the reference examples only constants are read (their ``main``
writes ``/tmp/quickstart_ckpt`` or needs 8 XLA devices); the reference side
of each comparison is its library: the jitted single-device train step from
converted weights, its prefill, its scheduler and elastic controller.
Tolerances are the port's: losses and grad norms at 3e-2
(tests/test_torch_train.py), prefill logits at 6e-2 (tests/test_torch_serve.py),
a resumed trace at rtol 1e-5 (tests/test_torch_train.py). Also the launch
counters of K1-K5 under threads.
"""
import ast
import dataclasses
import importlib.util
import inspect
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSuite as JShapeSuite
from repro.configs.registry import get_config as jax_get_config
from repro.core.collocation import CollocationScheduler as JScheduler
from repro.core.device import get_sku as jax_get_sku
from repro.core.elastic import ElasticController as JElastic
from repro.core.instance import JobSpec as JJobSpec
from repro.core.profiles import homogeneous_layout as jax_homogeneous_layout
from repro.models.model_api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.runtime import train_step as jts
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSuite
from repro_torch.convert import from_jax_train_state
from repro_torch.core.partitioner import device_memory_bytes, partition, partition_homogeneous, verify_disjoint
from repro_torch.core.device import get_sku
from repro_torch.core.instance import JobSpec
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rwkv6_scan as trk
from repro_torch.models.model_api import build_model
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CPU = torch.device("cpu")
TOL_TRAIN = 3e-2
TOL_LOGITS = dict(atol=6e-2, rtol=6e-2)
TOL_RESUME = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while these tests run: the suite's worker
    processes share the host's cores, and the twins' many small ops on a pool
    of threads a worker wait on each other's time slices (the file took 14x
    its one-core time so)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    return load("quickstart_torch")


@pytest.fixture(scope="module")
def train_lm():
    return load("train_lm_torch")


@pytest.fixture(scope="module")
def sweep():
    return load("collocated_hparam_sweep_torch")


@pytest.fixture(scope="module")
def failover():
    return load("elastic_failover_torch")


def reference_constants(name: str, monkeypatch):
    """A reference example's module, loaded with its XLA_FLAGS default undone
    afterwards (it sets one at import, for its own process)."""
    monkeypatch.setenv("XLA_FLAGS", "")
    return load(name)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_jax(tree):
    """The port's parameters as the reference's, type kept (bf16 through f32: exact)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# partition_homogeneous
# ---------------------------------------------------------------------------

HOMOGENEOUS = [(sku, p.name) for sku in ("h100-80gb", "a100-40gb") for p in get_sku(sku).profiles]


@pytest.mark.parametrize("sku,profile", HOMOGENEOUS, ids=[f"{s}-{p}" for s, p in HOMOGENEOUS])
def test_partition_homogeneous_matches_the_reference_layout(sku, profile):
    insts = partition_homogeneous(CPU, profile, sku=sku)
    want = jax_homogeneous_layout(profile, sku=sku)
    assert [(i.placement.profile, i.placement.start) for i in insts] == [(p.profile, p.start) for p in want]
    verify_disjoint(insts)
    dev, jdev = get_sku(sku), jax_get_sku(sku)
    units = dev.profile(profile).mem_units
    assert units == jdev.profile(profile).mem_units
    for inst in insts:
        assert inst.units == dev.span(inst.placement) and inst.units[1] - inst.units[0] == units
        assert inst.hbm_budget_bytes == device_memory_bytes(CPU) * units // dev.n_units


@pytest.mark.parametrize("sku,profile,n", [("h100-80gb", "1g.10gb", 7), ("a100-40gb", "2g.10gb", 3)])
def test_partition_homogeneous_counts(sku, profile, n):
    """The paper's 7 x 1g on Hopper, each one memory unit and an eighth of the
    memory; and tests/test_multidevice.py's 3 x 2g.10gb on the A100."""
    insts = partition_homogeneous(CPU, profile, sku=sku)
    assert len(insts) == n
    assert sorted(u for i in insts for u in range(*i.units)) == list(range(sum(i.units[1] - i.units[0]
                                                                                for i in insts)))
    if profile == "1g.10gb":
        assert all(i.units[1] - i.units[0] == 1 for i in insts)
        assert {i.hbm_budget_bytes for i in insts} == {device_memory_bytes(CPU) // 8}


# ---------------------------------------------------------------------------
# every twin runs on the card by default
# ---------------------------------------------------------------------------

TWINS = ["quickstart_torch", "train_lm_torch", "collocated_hparam_sweep_torch", "elastic_failover_torch"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_needs_a_card_by_default(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setattr(registry, "CONFIGS", dict(registry.CONFIGS))
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main([])
    assert "lm-100m" not in registry.CONFIGS


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_tracks_the_reference(quickstart):
    """From converted weights, the twin's 30 steps against the reference's
    jitted step (first 5 losses and grad norms at 3e-2); then the prefill
    logits of the twin's trained parameters through both packages."""
    cfg = quickstart.quickstart_config(reduced=True)
    jcfg = dataclasses.replace(jax_get_config("llama3-8b").reduced(), n_layers=cfg.n_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.rope_theta == 500_000.0 and cfg.q_groups == 2
    jmodel = jax_build_model(jcfg)
    jopt = jadamw.AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=30)
    numbers = lambda opt: {k: v for k, v in dataclasses.asdict(opt).items() if k != "mu_dtype"}  # noqa: E731
    assert numbers(quickstart.OPT) == numbers(jopt)
    jstate = jts.init_train_state(jmodel, jax.random.key(0), jopt)
    state = from_jax_train_state(jax.device_get(jstate), "cpu")
    jstep = jax.jit(jts.build_train_step(jmodel, jax_make_plan(jcfg, None), jopt))
    assert dataclasses.astuple(quickstart.SUITE) == ("quickstart", 64, 4, "train")
    want = []
    for i in range(5):
        batch = {k: jnp.asarray(v) for k, v in synthetic.batch_for(cfg, quickstart.SUITE, seed=0, step=i).items()}
        jstate, jm = jstep(jstate, batch)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))

    model, plan = build_model(cfg), make_plan(cfg, None)
    state, losses, grad_norms = quickstart.train(model, plan, cfg, state, CPU)
    assert len(losses) == quickstart.STEPS == 30 and np.isfinite(losses).all()
    for i, (loss, gn) in enumerate(want):
        np.testing.assert_allclose(losses[i], loss, atol=TOL_TRAIN, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(grad_norms[i], gn, rtol=TOL_TRAIN, err_msg=f"grad norm, step {i}")

    prompt = synthetic.token_batch(cfg.vocab, 2, 8, seed=1)["tokens"]
    with torch.no_grad():
        last, _ = model.prefill(state["params"], {"tokens": torch.from_numpy(prompt)}, plan)
    jlast, _ = jmodel.prefill(_to_jax(state["params"]), {"tokens": jnp.asarray(prompt)}, jax_make_plan(jcfg, None))
    assert last.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL_LOGITS)


def test_quickstart_main_round_trips_the_checkpoint(quickstart, tmp_path, capsys):
    out = quickstart.main(["--device", "cpu", "--reduced", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["ckpt_exact"] and out["ckpt_step"] == 30
    # a second restore from the directory gives the same bytes again
    again, _ = CheckpointStore(tmp_path / "ckpt").restore(out["state"])
    pairs = zip(quickstart.state_leaves(again), quickstart.state_leaves(out["state"]), strict=True)
    assert all(quickstart.bit_equal(a, b) for a, b in pairs)
    assert int(out["state"]["opt"].step) == 30
    assert out["tokens"].shape == (2, quickstart.NEW_TOKENS) and out["tokens"].dtype == torch.int32
    printed = capsys.readouterr().out
    for line in ("step  10  loss=", "step  30  loss=", "checkpoint saved + restored at step 30", "generated tokens:"):
        assert line in printed


def test_bit_equal_tells_bytes_apart(quickstart):
    a = torch.tensor([0.0, 1.0])
    assert quickstart.bit_equal(a, a.clone())
    assert not quickstart.bit_equal(a, torch.tensor([-0.0, 1.0]))  # equal as numbers, not as bytes
    assert not quickstart.bit_equal(a, a.double())


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_lm100m_is_the_references_config_and_size(train_lm, monkeypatch):
    ref = reference_constants("train_lm", monkeypatch)
    assert dataclasses.asdict(train_lm.LM100M) == dataclasses.asdict(ref.LM100M)
    assert train_lm.LM100M.resolved_head_dim == 64
    assert build_model(train_lm.LM100M).param_count() == jax_build_model(ref.LM100M).param_count()


def test_train_lm_loss_falls(train_lm, tmp_path, monkeypatch):
    """30 steps at seq 32: with the launcher's 20 warm-up steps a run of 6
    moves the loss by less than its step-to-step noise, up or down, in the
    reference as in the port."""
    monkeypatch.setattr(registry, "CONFIGS", dict(registry.CONFIGS))
    r = train_lm.main(["--device", "cpu", "--reduced", "--steps", "30", "--seq", "32",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert r["steps"] == 30 and r["final_loss"] < r["first_loss"]
    assert r["tail_mean_loss"] < r["head_mean_loss"]
    assert CheckpointStore(tmp_path / "ckpt").latest_step() == 30


# ---------------------------------------------------------------------------
# schedules: the sweep and the failover against the reference's library
# ---------------------------------------------------------------------------


def _reference_db(cfg_name, suite_name, sku):
    return {(cfg_name, suite_name, p.name): {"fits": True, "step_s": 0.1, "peak_bytes_per_device": 0}
            for p in jax_get_sku(sku).profiles}


def _placements(schedule):
    return [(a.job.name, a.profile, a.placement.start) for a in schedule.assignments]


@pytest.mark.parametrize("sku", ["a100-40gb", "h100-80gb"])
@pytest.mark.parametrize("n_jobs", [7, 3])
def test_sweep_schedule_is_the_references(sweep, sku, n_jobs, monkeypatch):
    ref = reference_constants("collocated_hparam_sweep", monkeypatch)
    assert (sweep.LRS, sweep.STEPS) == (ref.LRS, ref.STEPS)
    cfg = sweep.sweep_config(reduced=True)
    suite = ShapeSuite("sweep", 32, 4, "train")
    _, schedule = sweep.make_schedule(cfg, suite, sweep.LRS[:n_jobs], sku)
    jsuite = JShapeSuite("sweep", 32, 4, "train")
    jobs = [JJobSpec(f"lr={lr:.1e}", cfg.name, jsuite) for lr in ref.LRS[:n_jobs]]
    want = JScheduler(_reference_db(cfg.name, jsuite.name, sku), sku=sku).schedule(jobs)
    assert _placements(schedule) == _placements(want) and not want.rejections
    if sku == "a100-40gb":  # the reference example's own char DB
        assert [p.name for p in jax_get_sku(sku).profiles] == ["1g.5gb", "2g.10gb", "3g.20gb", "4g.20gb", "7g.40gb"]
    insts = partition(CPU, [a.placement for a in schedule.assignments], sku=sku)
    verify_disjoint(insts)


@pytest.mark.parametrize("sku", ["a100-40gb", "h100-80gb"])
def test_failover_repack_is_the_references(failover, sku, monkeypatch):
    ref = reference_constants("elastic_failover", monkeypatch)
    assert (failover.STEPS_BEFORE, failover.STEPS_AFTER) == (ref.STEPS_BEFORE, ref.STEPS_AFTER)
    cfg = failover.failover_config(reduced=True)
    suite, jsuite = ShapeSuite("ft", 32, 4, "train"), JShapeSuite("ft", 32, 4, "train")
    sched = failover.make_scheduler(cfg, suite, sku)
    jsched = JScheduler(_reference_db(cfg.name, jsuite.name, sku), sku=sku)
    schedule = sched.schedule([JobSpec(f"job{i}", cfg.name, suite) for i in range(failover.N_JOBS)])
    want = jsched.schedule([JJobSpec(f"job{i}", cfg.name, jsuite) for i in range(3)])
    assert _placements(schedule) == _placements(want)
    ctrl, jctrl = failover.ElasticController(sched), JElastic(jsched)
    ctrl.mark_failed([0])
    jctrl.mark_failed([0])
    event, jevent = ctrl.repack(schedule), jctrl.repack(want)
    assert (event.killed_jobs, event.survivors, event.resumed_from_checkpoint) == (
        jevent.killed_jobs, jevent.survivors, jevent.resumed_from_checkpoint)
    assert _placements(event.new_schedule) == _placements(jevent.new_schedule)
    assert event.killed_jobs == ("job0",) and event.survivors == ("job1", "job2")


def test_job_seed_is_stable(failover):
    import zlib

    assert [failover.job_seed(f"job{i}") for i in range(3)] == [zlib.crc32(f"job{i}".encode()) % 1000
                                                                 for i in range(3)]


# ---------------------------------------------------------------------------
# the sweep live, on the CPU
# ---------------------------------------------------------------------------


def test_sweep_threads_give_the_solo_traces(sweep, capsys):
    """The seven jobs' eight steps alone and then each in its thread: equal
    traces (the reference's live isolation test, tests/test_multidevice.py)."""
    r = sweep.main(["--device", "cpu", "--reduced"])
    names = [a.job.name for a in r["schedule"].assignments]
    assert len(names) == 7 and set(r["solo"]["traces"]) == set(names)
    assert [i.label for i in r["instances"]] == [f"1g.10gb@{u}" for u in range(7)]
    for name in names:
        assert len(r["solo"]["traces"][name]) == sweep.STEPS
        assert r["par"]["traces"][name] == r["solo"]["traces"][name], name
    assert r["winner"] == min(names, key=lambda n: r["par"]["traces"][n][-1])
    assert r["solo"]["device_peak"] is None and r["par"]["device_peak"] is None  # no device memory on the CPU
    printed = capsys.readouterr().out
    assert "schedule:" in printed and "<-- winner" in printed


def test_sweep_job_tracks_the_reference(sweep, monkeypatch):
    """One job of the sweep through the twin's ``run_job`` from converted
    weights, against the reference's jitted single-device step, 3 steps at
    3e-2."""
    cfg = sweep.sweep_config(reduced=True)
    jcfg = jax_get_config("granite-3-2b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    lr, steps = sweep.LRS[4], 3
    jmodel = jax_build_model(jcfg)
    jopt = jadamw.AdamWConfig(lr_peak=lr, warmup_steps=2, total_steps=steps)
    jstate = jts.init_train_state(jmodel, jax.random.key(0), jopt)
    converted = from_jax_train_state(jax.device_get(jstate), "cpu")
    monkeypatch.setattr(ts, "init_train_state", lambda model, gen, opt, device: converted)
    suite = ShapeSuite("sweep", 32, 4, "train")
    inst = partition(CPU, [get_sku("h100-80gb").homogeneous_layout("1g.10gb")[0]], sku="h100-80gb")[0]
    losses = sweep.run_job(inst, cfg, suite, lr, steps)
    jstep = jax.jit(jts.build_train_step(jmodel, jax_make_plan(jcfg, None), jopt))
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in synthetic.batch_for(cfg, suite, seed=0, step=i).items()}
        jstate, jm = jstep(jstate, batch)
        np.testing.assert_allclose(losses[i], float(jm["loss"]), atol=TOL_TRAIN, err_msg=f"loss, step {i}")


# ---------------------------------------------------------------------------
# failover live, on the CPU
# ---------------------------------------------------------------------------


def test_failover_resumes_as_if_uninterrupted(failover, tmp_path, capsys):
    """Every job's 8 steps, the killed one resumed on another instance and the
    survivors on theirs, against an uninterrupted 8-step run of the same job
    at rtol 1e-5."""
    r = failover.main(["--device", "cpu", "--reduced"])
    assert r["event"].killed_jobs == ("job0",)
    printed = capsys.readouterr().out
    assert "[job0] resumed from step 4 on 1g.10gb@3" in printed
    cfg, suite = r["config"], r["suite"]
    total = failover.STEPS_BEFORE + failover.STEPS_AFTER
    for a in r["event"].new_schedule.assignments:
        name = a.job.name
        inst = failover.instance_of(CPU, a.placement, "h100-80gb")
        whole = failover.train_steps(inst, cfg, suite, CheckpointStore(tmp_path / name), name, total,
                                     seed=failover.job_seed(name))
        assert len(r["traces"][name]) == total
        np.testing.assert_allclose(r["traces"][name], whole, rtol=TOL_RESUME, err_msg=name)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

COUNTERS = {tfa: ["dkv_launch_count", "dq_launch_count", "launch_count"], tda: ["launch_count"],
            trk: ["launch_count"]}


def test_every_launch_site_counts_through_count_launch():
    """Each of the five K1-K5 launch counters is raised at one place, by
    ``_build.count_launch(globals(), name)`` under its lock, and nowhere by a
    bare ``+=``, which threads could interleave. The launch sites run only on
    a CUDA tensor, so their source is read."""
    for mod, names in COUNTERS.items():
        tree = ast.parse(inspect.getsource(mod))
        counted = sorted(
            node.args[1].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and ast.unparse(node.func) == "_build.count_launch"
            and ast.unparse(node.args[0]) == "globals()")
        assert counted == names, mod.__name__
        bare = [ast.unparse(node) for node in ast.walk(tree)
                if isinstance(node, ast.AugAssign) and ast.unparse(node.target) in names]
        assert not bare, f"{mod.__name__}: {bare}"
        assert all(getattr(mod, n) >= 0 for n in names)


class _Yielding(dict):
    """A counter namespace whose reads give the other threads their turn:
    between a read and its write, as a free-threaded interpreter may."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_count_launch_is_atomic():
    """With a thread switch between the read and the write of every count,
    an unguarded ``+= 1`` loses most counts; ``count_launch`` loses none."""
    counters = _Yielding(launch_count=0)
    n_threads, per_thread = 8, 300
    threads = [threading.Thread(target=lambda: [_build.count_launch(counters, "launch_count")
                                                for _ in range(per_thread)])
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert counters["launch_count"] == n_threads * per_thread
