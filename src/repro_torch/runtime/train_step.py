"""Train step builders: gradient accumulation and the sharding glue (PyTorch
twin of ``repro.runtime.train_step``).

``build_train_step`` returns a function over a train state dict
``{"params", "opt"}`` that takes the gradient of ``model.loss`` with
``torch.autograd.grad`` and applies AdamW. The state is updated in place (see
``optim.adamw.apply_updates``) and returned.

``jit_train_step`` keeps the reference's name; it returns an eager callable
(PyTorch has no ``jit`` the port needs) over a state whose parameters and
AdamW moments are DTensors on a ``DeviceMesh``, placed by the reference's
spec rules (``state_shardings``), and a batch sharded over the data axes
(``batch_shardings``); ``sharding.dist.distribute`` puts a whole state or
batch there, as ``jax.device_put`` does. The state is updated in place, the
twin of donation. Two kinds of step:

  * ``baseline`` and ``sp``: DTensors flow through the model, ``plan.act``
    redistributes the activations, and the kernels and the plain recurrences
    (the chunked WKV6 and SSD scans, ResNet's convolutions) run on each
    rank's local shards (``kernels/ops.py``, ``sharding.dist.on_shards``).
    Every family. On the card a sharded rwkv6 train step raises, as the
    single-device one does: its scan is the WKV6 kernel, which has no
    backward (nor has the reference's), and nothing scans some other way
    there; off the card it differentiates the plain ``wkv_chunked``;
  * ``zero``: each step gathers the weights and runs the unchanged model on
    plain local tensors with the null plan, each device computing whole
    examples; the gradients are summed to the parameters' shards
    (reduce-scatter) and AdamW updates the shards. Every family.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ShapeSuite
from repro_torch.models.model_api import Model
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.sharding import dist
from repro_torch.sharding.plan import (
    NamedSharding,
    P,
    ShardingPlan,
    make_plan,
    named_shardings,
    param_pspecs,
    validate_pspecs,
    zero_param_pspecs,
)

TrainState = Dict[str, Any]  # {"params": nested dict, "opt": AdamWState}
Batch = Dict[str, torch.Tensor]


def init_train_state(
    model: Model, gen: torch.Generator, opt_cfg: adamw.AdamWConfig, device="cuda"
) -> TrainState:
    """Random parameters from ``gen`` (which must live on ``device``) and a zero optimizer state."""
    params = model.init(gen, device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def build_grads(
    model: Model, plan: ShardingPlan, *, grad_accum: int = 1
) -> Callable[[Any, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor], list]]:
    """(params, batch) -> (loss, metrics, gradients in ``tree_leaves`` order).

    grad_accum > 1 splits the batch into ``grad_accum`` microbatches along
    dim 0 and sums their gradients in f32 buffers, as the reference's
    ``lax.scan`` body does; the loss is the microbatches' mean and the other
    metrics are the last microbatch's. Under a mesh the loss and metrics come
    back whole on every rank and each gradient in its parameter's placements.
    """

    def grads_of(params, batch):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = model.loss(params, batch, plan)
        loss = dist.full(loss)
        grads = torch.autograd.grad(loss, leaves)
        grads = [dist.like(g, p) for g, p in zip(grads, leaves)]
        return loss.detach(), {k: dist.full(v).detach() for k, v in metrics.items()}, grads

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

    def grads_fn(params, batch):
        for k, v in batch.items():
            if v.shape[0] % grad_accum:
                raise ValueError(f"batch {k!r} of {v.shape[0]} does not split into {grad_accum} microbatches")
        return grads_of(params, batch) if grad_accum == 1 else accumulated(params, batch)

    return grads_fn


def build_train_step(
    model: Model,
    plan: ShardingPlan,
    opt_cfg: adamw.AdamWConfig,
    *,
    grad_accum: int = 1,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state, metrics), with optional microbatching
    (``build_grads``)."""
    grads_fn = build_grads(model, plan, grad_accum=grad_accum)

    def train_step(state: TrainState, batch: Batch):
        params = state["params"]
        loss, metrics, grads = grads_fn(params, batch)
        grads = tree_unflatten(params, grads)
        new_params, new_opt, opt_metrics = adamw.apply_updates(params, grads, state["opt"], opt_cfg)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# sharding glue
# ---------------------------------------------------------------------------


def param_shapes(model: Model):
    """The parameter tree on the meta device: shapes and types, no storage."""
    return model.init(torch.Generator(device="cpu"), "meta")


def state_shardings(model: Model, mesh, variant: str = "baseline"):
    """``NamedSharding`` tree for the train state, from the rule-based specs."""
    params_shape = param_shapes(model)
    if variant == "zero":
        specs = zero_param_pspecs(params_shape, mesh)
    else:
        specs = validate_pspecs(params_shape, param_pspecs(params_shape), mesh)
    p_sh = named_shardings(params_shape, specs, mesh)
    scalar = NamedSharding(mesh, P())
    return {"params": p_sh, "opt": adamw.AdamWState(step=scalar, m=p_sh, v=p_sh)}


def batch_shardings(model: Model, mesh, suite: ShapeSuite, plan: ShardingPlan):
    specs = model.input_specs(suite)
    batch_axes = plan.spec("tokens")[0] if len(plan.spec("tokens")) else None
    out = {}
    for k, (shape, _) in specs.items():
        # batch dim over the data axes (when divisible — plan.spec('tokens')
        # already encodes the fallback), remaining dims unsharded.
        spec = P(batch_axes, *((None,) * (len(shape) - 1)))
        if k in ("patches", "frames"):
            spec = plan.spec("frames")
        out[k] = NamedSharding(mesh, spec)
    return out


def _zero_step(model: Model, mesh, plan: ShardingPlan, opt_cfg: adamw.AdamWConfig, grad_accum: int):
    """The ``zero`` step: gather, compute whole examples locally, reduce-scatter.
    The model runs with the null plan but for ``batch_sum``: a statistic over
    the batch (BatchNorm's) sums over the ranks that split it."""
    local = ShardingPlan(None, {}, (), None, batch_sum=dist.batch_sum_over(mesh, plan.dp_axes))
    grads_fn = build_grads(model, local, grad_accum=grad_accum)
    world = mesh.size()

    def step(state: TrainState, batch: Batch):
        from torch.distributed.tensor import Partial

        params = state["params"]
        whole = tree_map(lambda p: dist.full(p).detach(), params)
        loss, metrics, grads = grads_fn(whole, {k: dist.local(v) for k, v in batch.items()})
        del whole
        partial = [Partial()] * mesh.ndim
        # each rank's gradient of its own examples' mean loss; the global
        # gradient is their mean over the ranks (ranks that share a batch
        # shard count it alike), summed in f32
        grads = [dist.like(dist.from_local(g.float(), mesh, partial), p).div_(world)
                 for g, p in zip(grads, tree_leaves(params))]
        grads = tree_unflatten(params, grads)
        mean = lambda x: dist.all_sum(x.float(), mesh) / world  # noqa: E731
        new_params, new_opt, opt_metrics = adamw.apply_updates(params, grads, state["opt"], opt_cfg)
        del grads
        metrics = dict({k: mean(v) for k, v in metrics.items()}, loss=mean(loss), **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def jit_train_step(
    model: Model,
    mesh,
    suite: ShapeSuite,
    opt_cfg: adamw.AdamWConfig,
    *,
    grad_accum: int = 1,
    donate: bool = True,
    variant: str = "baseline",
):
    """The sharded train step + (state_shardings, batch_shardings, plan).

    The step takes a state and a batch placed by the shardings it returns
    (``dist.distribute``) and updates the state in place, as the reference's
    donated step does. It has no non-donating form: ``donate=False``, which
    would leave the caller's state valid, raises.
    """
    if not donate:
        raise NotImplementedError("jit_train_step updates the state in place; donate=False has no counterpart")
    plan = make_plan(model.cfg, mesh, suite, variant=variant)
    st_sh = state_shardings(model, mesh, variant)
    b_sh = batch_shardings(model, mesh, suite, plan)
    if variant == "zero":
        return _zero_step(model, mesh, plan, opt_cfg, grad_accum), st_sh, b_sh, plan
    inner = build_train_step(model, plan, opt_cfg, grad_accum=grad_accum)

    def step(state: TrainState, batch: Batch):
        with dist.implicit_replication():
            return inner(state, batch)

    return step, st_sh, b_sh, plan
