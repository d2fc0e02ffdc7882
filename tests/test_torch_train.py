"""PyTorch port vs the JAX reference: the train step and the training launcher.

From converted initial weights, the port's ``build_train_step`` and the
reference's jitted one see the same ``batch_for`` batches; their first 5
losses and grad norms agree to 3e-2, the reference's own loss tolerance
(tests/test_variants.py): the two frameworks round bf16 at different places
and the difference grows with the steps. Then the twins of
tests/test_train_integration.py through ``repro_torch.launch.train.run`` on the
CPU.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSuite as JShapeSuite
from repro.configs.registry import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models.model_api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.runtime import train_step as jts
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.data import synthetic
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
#: stablelm-12b reduced with its head_dim of 160 kept, as in test_torch_serve.py
D160 = dict(d_model=640, n_heads=4, n_kv_heads=1, head_dim=160, d_ff=256, vocab=256)


def reduced_configs(arch):
    """(reference config, port config) of ``arch`` reduced; ``*-d160`` keeps head_dim 160."""
    name, overrides = (arch[: -len("-d160")], D160) if arch.endswith("-d160") else (arch, {})
    return jax_get_config(name).reduced(**overrides), get_config(name).reduced(**overrides)


def _batch(cfg, step, batch=4, seq=32):
    return synthetic.batch_for(cfg, ShapeSuite("t", seq, batch, "train"), seed=0, step=step)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-72b", "stablelm-12b-d160", "olmoe-1b-7b", "zamba2-7b",
                                  "whisper-base"])
def test_first_steps_track_the_reference(arch):
    jcfg, cfg = reduced_configs(arch)
    jmodel = jax_build_model(jcfg)
    jopt = jadamw.AdamWConfig(**OPT)
    jstate = jts.init_train_state(jmodel, jax.random.key(0), jopt)
    jstep = jax.jit(jts.build_train_step(jmodel, jax_make_plan(jcfg, None), jopt))

    model = build_model(cfg)
    opt = adamw.AdamWConfig(**OPT)
    state = from_jax_train_state(jax.device_get(jstate), "cpu")
    step = ts.build_train_step(model, make_plan(cfg, None), opt)
    if arch == "qwen2-72b":
        assert "bq" in state["params"]["layers"]["attn"]

    for i in range(5):
        batch = _batch(cfg, i)
        jstate, jm = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()})
        state, m = step(state, from_jax_params(batch, "cpu"))  # whisper's frames are bf16 numpy
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=3e-2, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=3e-2,
                                   err_msg=f"grad norm, step {i}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["opt"].step) == 5


def _port_state(cfg, seed=0):
    model = build_model(cfg)
    opt = adamw.AdamWConfig(**OPT)
    return model, opt, ts.init_train_state(model, torch.Generator().manual_seed(seed), opt, "cpu")


def test_grad_accum_matches_full_batch():
    """grad_accum=2 over batch 8 == one step over the same batch 8, up to f32
    accumulation order (the reference's 2e-3)."""
    cfg = get_config("granite-3-2b").reduced()
    losses = {}
    for accum in (1, 2):
        model, opt, state = _port_state(cfg, seed=3)
        step = ts.build_train_step(model, make_plan(cfg, None), opt, grad_accum=accum)
        losses[accum] = []
        for i in range(4):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg, i, batch=8).items()})
            losses[accum].append(float(m["loss"]))
    np.testing.assert_allclose(losses[2], losses[1], rtol=2e-3)


def test_remat_gives_the_same_step(monkeypatch):
    """cfg.remat checkpoints every layer: the body runs twice a step (forward
    and again in backward) and the numbers do not change."""
    calls = {"n": 0}
    block_fwd = transformer.block_fwd

    def counted(*args):
        calls["n"] += 1
        return block_fwd(*args)

    monkeypatch.setattr(transformer, "block_fwd", counted)
    base = get_config("granite-3-2b").reduced()
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model, opt, state = _port_state(cfg)
        step = ts.build_train_step(model, make_plan(cfg, None), opt)
        calls["n"] = 0
        state, m = step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()})
        out[remat] = (float(m["loss"]), float(m["grad_norm"]), state["params"])
        assert calls["n"] == cfg.n_layers * (2 if remat else 1)
    assert out[True][:2] == pytest.approx(out[False][:2], rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out[True][2]), jax.tree_util.tree_leaves(out[False][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# twins of tests/test_train_integration.py, through the launcher
# ---------------------------------------------------------------------------


def _args(**overrides):
    base = dict(
        arch="granite-3-2b", reduced=True, steps=20, batch=4, seq=32,
        grad_accum=1, lr=1e-3, warmup=5, seed=0, workers=2, max_queue_size=4,
        ckpt_dir="", ckpt_every=50, log_every=100, mesh="none", metrics_out="",
        total_steps=20, device="cpu",
    )
    base.update(overrides)
    return argparse.Namespace(**base)


def test_loss_decreases_over_training():
    r = ttrain.run(_args(steps=30))
    assert r["tail_mean_loss"] < r["head_mean_loss"], r
    assert np.isfinite(r["final_loss"])


def test_resume_matches_uninterrupted(tmp_path):
    full = ttrain.run(_args(steps=20, ckpt_dir=str(tmp_path / "full"), ckpt_every=100))
    ttrain.run(_args(steps=10, ckpt_dir=str(tmp_path / "resume"), ckpt_every=10))
    part2 = ttrain.run(_args(steps=20, ckpt_dir=str(tmp_path / "resume"), ckpt_every=100))
    assert part2["steps"] == 10  # resumed from 10
    np.testing.assert_allclose(part2["final_loss"], full["final_loss"], rtol=1e-5)


def test_launcher_grad_accum_matches_full_batch():
    a = ttrain.run(_args(steps=5, batch=8, grad_accum=1, seed=3))
    b = ttrain.run(_args(steps=5, batch=8, grad_accum=2, seed=3))
    np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=2e-3)


def test_result_keys_and_flags_equal_the_reference(tmp_path):
    jargs = jtrain.build_argparser().parse_args(["--arch", "granite-3-2b", "--reduced"])
    targs = ttrain.build_argparser().parse_args(["--arch", "granite-3-2b", "--reduced"])
    assert set(vars(targs)) == set(vars(jargs)) | {"device"}
    assert {k: v for k, v in vars(targs).items() if k != "device"} == vars(jargs)
    assert targs.device == "cuda"  # the port runs on the card unless told otherwise
    small = dict(steps=4, batch=2, seq=16, warmup=1, total_steps=4, workers=1, log_every=100)
    want = jtrain.run(argparse.Namespace(**{**vars(_args(**small)), "device": None}))
    got = ttrain.run(_args(**small, metrics_out=str(tmp_path / "m.json")))
    assert list(got) == list(want)
    assert list(got["pipeline"]) == list(want["pipeline"])
    assert (tmp_path / "m.json").exists()

