"""Train step builder with gradient accumulation (PyTorch twin of
``repro.runtime.train_step``).

``build_train_step`` returns a function over a train state dict
``{"params", "opt"}`` that takes the gradient of ``model.loss`` with
``torch.autograd.grad`` and applies AdamW. The state is updated in place (see
``optim.adamw.apply_updates``) and returned. Single device only: the
reference's ``jit_train_step``, ``state_shardings`` and ``batch_shardings``
wait for the multi-device slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.model_api import Model
from repro_torch.models.module import tree_leaves, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.sharding.plan import ShardingPlan

TrainState = Dict[str, Any]  # {"params": nested dict, "opt": AdamWState}
Batch = Dict[str, torch.Tensor]


def init_train_state(
    model: Model, gen: torch.Generator, opt_cfg: adamw.AdamWConfig, device="cuda"
) -> TrainState:
    """Random parameters from ``gen`` (which must live on ``device``) and a zero optimizer state."""
    params = model.init(gen, device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def build_train_step(
    model: Model,
    plan: ShardingPlan,
    opt_cfg: adamw.AdamWConfig,
    *,
    grad_accum: int = 1,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state, metrics), with optional microbatching.

    grad_accum > 1 splits the batch into ``grad_accum`` microbatches along
    dim 0 and sums their gradients in f32 buffers, as the reference's
    ``lax.scan`` body does; the loss is the microbatches' mean and the other
    metrics are the last microbatch's.
    """

    def grads_of(params, batch):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = model.loss(params, batch, plan)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def accumulated(params, batch):
        g_acc = None
        loss_sum = None
        for i in range(grad_accum):
            mb = {k: v.chunk(grad_accum, dim=0)[i] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            if g_acc is None:
                g_acc = [g.float() for g in grads]
                loss_sum = loss.float()
            else:
                for a, g in zip(g_acc, grads):
                    a.add_(g.float())
                loss_sum = loss_sum + loss
            del grads
        for a in g_acc:
            a.div_(grad_accum)
        return loss_sum / grad_accum, metrics, g_acc

    def train_step(state: TrainState, batch: Batch):
        params = state["params"]
        for k, v in batch.items():
            if v.shape[0] % grad_accum:
                raise ValueError(f"batch {k!r} of {v.shape[0]} does not split into {grad_accum} microbatches")
        loss, metrics, grads = grads_of(params, batch) if grad_accum == 1 else accumulated(params, batch)
        grads = tree_unflatten(params, grads)
        new_params, new_opt, opt_metrics = adamw.apply_updates(params, grads, state["opt"], opt_cfg)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
