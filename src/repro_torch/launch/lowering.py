"""Step builders shared by the characterization (PyTorch twin of
``repro.launch.lowering``).

The reference lowers a step function on a mesh and hands back the compiled
program for its costs. PyTorch runs eagerly and has no program to hand back:
``build_cell`` builds what ``launch/train.py`` builds, on one device, ready to
run and to measure (``core/instance.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ShapeSuite
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.plan import make_plan


def active_params(cfg, total: int) -> int:
    """Params touched per token (MoE: shared + top_k routed experts only)."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    inactive_experts = m.n_experts - m.top_k
    per_expert = 3 * cfg.d_model * m.d_expert
    return total - cfg.n_layers * inactive_experts * per_expert


def _batch(cfg, suite: ShapeSuite, seed: int) -> dict:
    if cfg.family == "resnet":
        # the config's own image size and classes, so that its CPU-scale form
        # gets images of its size (at full size the paper's dataset's)
        spec = synthetic.DatasetSpec(cfg.name, 0, 0, image_size=cfg.img_size, n_classes=cfg.n_classes)
        return synthetic.image_batch(spec, suite.global_batch, seed=seed)
    return synthetic.batch_for(cfg, suite, seed=seed)


def build_cell(cfg, suite: ShapeSuite, device, *, seed: int = 0):
    """The train step of the model ``cfg`` under ``suite`` on ``device``, as
    the launcher builds it: the model, random parameters and a zero AdamW
    state from ``seed``, the synthetic batch of step 0 on ``device``, and the
    step function. Returns ``(model, state, batch, step)``.

    Train suites only: prefill and decode cells are not ported yet
    (ROADMAP.md, Queue 1).
    """
    if suite.kind != "train":
        raise NotImplementedError(
            f"suite {suite.name!r} is a {suite.kind} suite: only train suites are "
            "characterized by the port yet (ROADMAP.md, Queue 1)"
        )
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    step = ts.build_train_step(model, make_plan(cfg, None), opt_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = ts.init_train_state(model, gen, opt_cfg, device)
    batch = {
        k: torch.from_numpy(np.asarray(v)).to(device)
        for k, v in _batch(cfg, suite, seed).items()
    }
    return model, state, batch, step
