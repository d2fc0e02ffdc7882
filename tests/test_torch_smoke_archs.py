"""Twin of tests/test_smoke_archs.py over the port's whole registry: every
architecture builds, its parameter count (the port's taken on the meta
device, which allocates nothing) equals the reference's (taken by
``jax.eval_shape``), and at its reduced size it takes one train step on the
CPU and serves a prefill and a decode step, with finite outputs of the
expected shapes. No family is left out.
"""
import numpy as np
import pytest
import torch

from repro.configs.registry import CONFIGS as JAX_CONFIGS
from repro.models.model_api import build_model as jax_build_model
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import ASSIGNED, CONFIGS
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.runtime.serve_step import pad_cache
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan

SUITE = ShapeSuite("smoke", 32, 2, "train")


def _batch(cfg, model, seed=0):
    """A batch of the model's train input specs: ids below the vocab (or the
    class count), normal values elsewhere; numpy from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in model.input_specs(SUITE).items():
        if dtype in (torch.int32, torch.int64):
            hi = cfg.n_classes if cfg.family == "resnet" else cfg.vocab
            out[name] = torch.from_numpy(rng.integers(0, hi, shape, dtype=np.int32)).to(dtype)
        else:
            out[name] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
    return out


def test_the_registry_is_the_reference_registry():
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_arch_builds_with_the_reference_param_count(arch):
    model = build_model(CONFIGS[arch])
    assert model.param_count() == jax_build_model(JAX_CONFIGS[arch]).param_count()


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_loss_and_grad_step(arch):
    cfg = CONFIGS[arch].reduced()
    model = build_model(cfg)
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    state = ts.init_train_state(model, torch.Generator().manual_seed(1), opt, "cpu")
    before = [v.detach().clone() for v in tree_leaves(state["params"])]
    step = ts.build_train_step(model, make_plan(cfg, None), opt)
    state, metrics = step(state, _batch(cfg, model))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0, f"{arch}: loss {loss}"
    moved = max(float((a.detach().float() - b.float()).abs().max()) for a, b in zip(tree_leaves(state["params"]), before))
    assert moved > 0, f"{arch}: params unchanged"


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@torch.no_grad()
def test_serving_shapes(arch):
    cfg = ASSIGNED[arch].reduced()
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S), dtype=np.int32))}
    if cfg.n_patches:
        batch["patches"] = torch.zeros((B, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16)
    if cfg.enc_layers:
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model), dtype=torch.bfloat16)
    last, cache = model.prefill(params, batch, plan)
    assert last.shape == (B, cfg.padded_vocab) and torch.isfinite(last.float()).all()
    cache = pad_cache(cache, 1)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    db = {"token": torch.argmax(last, -1).to(torch.int32)}
    if cfg.enc_layers:
        db["frames"] = batch["frames"]
    logits, cache2 = model.decode(params, db, cache, S, plan)
    assert logits.shape == (B, cfg.padded_vocab) and torch.isfinite(logits.float()).all()
    # the cache's structure is kept (the port updates it in place)
    assert {k: tuple(v.shape) for k, v in cache2.items()} == shapes
