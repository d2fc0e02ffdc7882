"""PyTorch port vs the JAX reference: the ResNet trio (``repro_torch.models.resnet``).

From weights converted from the reference's init, the same images (numpy,
seeded) through both: logits and loss of ``resnet_small``, the reduced trio's
shapes, and the first losses of a reduced ``resnet_small`` through both
training launchers. Then the places where PyTorch's defaults differ from
the reference's: XLA's ``"SAME"`` padding, which is asymmetric where
``padding=k // 2`` is not, the max-pool's -inf padding, and BatchNorm's
population variance. Everything is f32 on both sides.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import PAPER_WORKLOADS as JAX_PAPER_WORKLOADS
from repro.configs.registry import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models import resnet as jresnet
from repro.models.model_api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.runtime import train_step as jts
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import PAPER_WORKLOADS, get_config
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.launch import train as ttrain
from repro_torch.models import resnet
from repro_torch.models.model_api import build_model
from repro_torch.sharding.plan import make_plan

# f32 on both sides; the two frameworks sum the convolutions and the batch
# statistics in other orders, through 26 layers
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)


def _images(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, (batch,), dtype=np.int32)
    return images, labels


def test_resnet_small_logits_and_loss_match_reference():
    jcfg, cfg = jax_get_config("resnet_small"), get_config("resnet_small")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    images, labels = _images(cfg, 4)
    want = jresnet.forward(jcfg, jparams, jnp.asarray(images), jax_make_plan(jcfg, None))
    got = resnet.forward(cfg, params, torch.from_numpy(images), make_plan(cfg, None))
    assert got.shape == (4, cfg.n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jloss, jm = jmodel.loss(jparams, {"images": jnp.asarray(images), "labels": jnp.asarray(labels)},
                            jax_make_plan(jcfg, None))
    loss, m = build_model(cfg).loss(params, {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)},
                                    make_plan(cfg, None))
    assert set(m) == set(jm) == {"ce", "accuracy"}
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]))


def test_reduced_trio_shapes():
    """Twin of tests/test_smoke_archs.py::test_resnet_trio_shapes, and the
    reduced trio's logits against the reference's from the same weights."""
    assert set(PAPER_WORKLOADS) == set(JAX_PAPER_WORKLOADS)
    for name, full in PAPER_WORKLOADS.items():
        cfg, jcfg = full.reduced(), JAX_PAPER_WORKLOADS[name].reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        x = torch.zeros((2, cfg.img_size, cfg.img_size, 3))
        logits = resnet.forward(cfg, params, x, make_plan(cfg, None))
        assert logits.shape == (2, cfg.n_classes)
        jparams = jax_build_model(jcfg).init(jax.random.key(1))
        images, _ = _images(cfg, 2, seed=1)
        want = jresnet.forward(jcfg, jparams, jnp.asarray(images), jax_make_plan(jcfg, None))
        got = resnet.forward(cfg, from_jax_params(jax.device_get(jparams), "cpu"), torch.from_numpy(images),
                             make_plan(cfg, None))
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=name)


def test_port_init_has_the_reference_tree():
    for name in PAPER_WORKLOADS:
        cfg = get_config(name).reduced()
        want = jax.eval_shape(jax_build_model(jax_get_config(name).reduced()).init, jax.random.key(0))
        got = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, want)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, got))
        for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
            assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == w.dtype.name


# ---------------------------------------------------------------------------
# "SAME" padding, the max-pool, BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size, k, stride, want", [
    (32, 3, 2, (0, 1)),     # the 3x3 stride-2 conv on an even size
    (224, 7, 2, (2, 3)),    # the 7x7 stride-2 stem
    (112, 3, 2, (0, 1)),    # the stem's max-pool
    (31, 3, 2, (1, 1)),
    (7, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0)),      # the strided 1x1 projection
])
def test_same_pads_are_xla_s(size, k, stride, want):
    assert resnet.same_pads(size, k, stride) == want


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("k, stride", [(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)])
def test_conv_same_padding_matches_lax(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5), dtype=np.float32)
    w = rng.standard_normal((k, k, 5, 6), dtype=np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = resnet.conv_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    lo, hi = resnet.same_pads(size, k, stride)
    if lo != hi:  # PyTorch's symmetric padding=k // 2 gives the same shape and other numbers
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
                       stride=stride, padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape == got.shape and not np.allclose(_np(sym), _np(want), atol=1e-2)


@pytest.mark.parametrize("size", [7, 8, 111, 112])
def test_max_pool_matches_reduce_window(size):
    rng = np.random.default_rng(size)
    # all negative: a pool padded with 0 instead of -inf shows on every edge window
    x = -np.abs(rng.standard_normal((2, size, size, 4), dtype=np.float32)) - 0.1
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = resnet.max_pool_same(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


def test_batchnorm_uses_the_population_variance():
    rng = np.random.default_rng(5)
    # 2 x 2 x 2 = 8 values a channel: the unbiased estimate would be 8/7 of it
    x = (rng.standard_normal((2, 2, 2, 3)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(3).astype(np.float32), "bias": rng.standard_normal(3).astype(np.float32)}
    want = jresnet.bn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = resnet.bn_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    xt = torch.from_numpy(x)
    unbiased = (xt - xt.mean((0, 1, 2))) * torch.rsqrt(xt.var((0, 1, 2)) + 1e-5) * torch.from_numpy(p["scale"])
    assert not np.allclose(_np(unbiased + torch.from_numpy(p["bias"])), _np(want), atol=1e-3)
    # a 16-bit input is normalized in f32 and comes back in its own type
    assert resnet.bn_apply({k: torch.from_numpy(v) for k, v in p.items()}, xt.bfloat16()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# training through both launchers
# ---------------------------------------------------------------------------


def _args(**overrides):
    base = dict(
        arch="resnet_small", reduced=True, steps=4, batch=4, seq=32, grad_accum=1, lr=1e-3, warmup=2,
        seed=0, workers=1, max_queue_size=4, ckpt_dir="", ckpt_every=50, log_every=100, mesh="none",
        metrics_out="", total_steps=4, device="cpu",
    )
    base.update(overrides)
    return argparse.Namespace(**base)


def test_first_train_losses_match_the_reference_launcher(monkeypatch):
    """The same reduced resnet_small, from the reference launcher's own init
    (converted), through both launchers: the same batches, the same losses."""
    args = _args()
    want = jtrain.run(argparse.Namespace(**{**vars(args), "device": None}))

    jcfg = jax_get_config(args.arch).reduced()
    jopt = jadamw.AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup, total_steps=args.total_steps)
    jstate = jts.init_train_state(jax_build_model(jcfg), jax.random.key(args.seed), jopt)
    state = from_jax_train_state(jax.device_get(jstate), "cpu")
    monkeypatch.setattr(ttrain.ts, "init_train_state", lambda *a, **k: state)
    got = ttrain.run(args)
    assert got["steps"] == want["steps"] == args.steps
    for key in ("first_loss", "head_mean_loss", "final_loss"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)


def test_resume_matches_uninterrupted(tmp_path):
    """The ResNet's train state (its blocks a list) checkpoints and resumes
    through the launcher as the transformer's does."""
    full = ttrain.run(_args(steps=4, ckpt_dir=str(tmp_path / "full"), ckpt_every=100))
    ttrain.run(_args(steps=2, ckpt_dir=str(tmp_path / "resume"), ckpt_every=2))
    part2 = ttrain.run(_args(steps=4, ckpt_dir=str(tmp_path / "resume"), ckpt_every=100))
    assert part2["steps"] == 2
    np.testing.assert_allclose(part2["final_loss"], full["final_loss"], rtol=1e-5)
