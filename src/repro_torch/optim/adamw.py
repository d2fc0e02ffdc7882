"""AdamW with decoupled weight decay and global-norm clipping (PyTorch twin of
``repro.optim.adamw``).

State mirrors the parameter tree: m and v in f32, a 0-d int32 step, all on the
parameters' device. The reference returns new arrays; ``apply_updates`` here
updates params, m and v **in place** (under ``torch.no_grad()``) and returns
the same tensors, so a step needs no second copy of the state. The update is
elementwise and runs in slices of ``CHUNK`` elements of each leaf, so its f32
temporaries stay small next to the state whatever the leaf's size; slicing
changes no number, only the order of the norm's partial sums.

Under a mesh (``runtime.train_step.jit_train_step``) params, gradients, m and
v are DTensors with the same placements: the update, elementwise, runs on
each rank's local shards, and the clip reads the global norm, every element
of every global gradient counted once (``global_norm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.models.module import tree_leaves, tree_map, tree_paths
from repro_torch.sharding import dist

Params = Any
Path = Tuple[str, ...]

#: elements of one slice of a leaf in the update (128 MB of f32)
CHUNK = 1 << 25


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Params  # f32, like params
    v: Params  # f32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: Any = torch.float32


def _slices(x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``x`` as flat slices of at most CHUNK elements (x contiguous)."""
    return iter(x.view(-1).split(CHUNK))


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to lr_min, as an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Params, cfg: AdamWConfig) -> AdamWState:
    device = next(tree_leaves(params)).device
    # a DTensor's moments are DTensors of its placements
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.mu_dtype, memory_format=torch.contiguous_format)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, cast a slice at a time.

    A DTensor leaf adds its local shard's sum, counted once over the ranks
    that replicate it (``dist.owned_sum``, one all-reduce for the tree): the
    norm of the global gradients, the same on every rank."""
    parts = []
    for leaf in tree_leaves(tree):
        sq = None
        for part in dist.local(leaf).reshape(-1).split(CHUNK):
            s = part.float().square().sum()
            sq = s if sq is None else sq + s
        parts.append((sq, leaf))
    return torch.sqrt(dist.owned_sum(parts))


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _decay_mask(path: Path) -> bool:
    """Decay matmul kernels / embeddings; skip norms, biases, gains."""
    leaf = path[-1] if path else ""
    no_decay = ("scale", "bias", "mu", "decay_base", "bonus_u", "b", "bq", "bk",
                "bv", "bo", "b_up", "b_down", "dt_bias", "a_log", "d_skip")
    return leaf not in no_decay


@torch.no_grad()
def apply_updates(
    params: Params,
    grads: Params,
    state: AdamWState,
    cfg: AdamWConfig,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step; params, m and v are updated in place and returned.

    The arithmetic is the reference's, in the same order: grads cast to f32
    and clipped by the global norm, ``m = b1 m + (1 - b1) g``,
    ``v = b2 v + (1 - b2) g^2``, ``u = (m / b1c) / (sqrt(v / b2c) + eps)``
    plus ``wd * p`` where ``_decay_mask`` says so, ``p = p - lr u`` in f32 and
    rounded back to the parameter's type.
    """
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    flat_g = dict(tree_paths(grads))
    flat_m = dict(tree_paths(state.m))
    flat_v = dict(tree_paths(state.v))
    for path, p in tree_paths(params):
        decay = bool(cfg.weight_decay) and _decay_mask(path)
        p_l, g_l, m_l, v_l = (dist.local(x) for x in (p, flat_g[path], flat_m[path], flat_v[path]))
        for p_s, g_s, m_s, v_s in zip(_slices(p_l), g_l.reshape(-1).split(CHUNK), _slices(m_l), _slices(v_l)):
            g32 = g_s.float() * clip
            v_s.mul_(cfg.b2).add_(g32.square().mul_(1 - cfg.b2))
            m_s.mul_(cfg.b1).add_(g32.mul_(1 - cfg.b1))
            u = (m_s / b1c).div_(torch.sqrt(v_s / b2c).add_(cfg.eps))
            if decay:
                u.add_(cfg.weight_decay * p_s.float())
            p_s.copy_(p_s.float() - lr * u)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
