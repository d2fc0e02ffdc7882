"""Serving-step builders: batched prefill and single-token decode against a
KV cache (sharded over a mesh by ``jit_prefill_step``/``jit_decode_step``),
and the eager greedy loop that joins them.

The ``jit_*`` builders keep the reference's names and return eager callables
over DTensors placed by ``param_shardings``/``cache_shardings``
(``sharding.dist.distribute`` places whole tensors there). The decode step
writes its new K/V and recurrent states into the cache's local shards, the
twin of the reference's donated cache. ``baseline`` and ``serve`` run
DTensors through the model of every serving family; ``zero`` gathers the
weights and runs any family on each rank's batch rows. ResNet has no
serving path: its steps raise the model's own error when called.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ShapeSuite
from repro_torch.models.model_api import Model
from repro_torch.models.module import tree_map
from repro_torch.runtime.train_step import param_shapes
from repro_torch.sharding import dist
from repro_torch.sharding.plan import (
    NamedSharding,
    P,
    ShardingPlan,
    _fit_spec,
    make_plan,
    named_shardings,
    param_pspecs,
    serve_param_pspecs,
    validate_pspecs,
    zero_param_pspecs,
)


def param_shardings(model: Model, mesh, variant: str = "baseline"):
    shape = param_shapes(model)
    if variant == "zero":
        specs = zero_param_pspecs(shape, mesh)
    elif variant == "serve":
        specs = serve_param_pspecs(shape, mesh)
    else:
        specs = validate_pspecs(shape, param_pspecs(shape), mesh)
    return named_shardings(shape, specs, mesh)


def cache_shardings(model: Model, mesh, suite: ShapeSuite, plan: ShardingPlan):
    """A ``NamedSharding`` for each leaf of ``model.cache_spec``: K/V over the
    plan's ``cache`` spec, recurrent states over ``state``, the small tails
    over the data axes; each fitted to its leaf's shape."""

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tree[0]
        if name in ("k", "v", "xk", "xv"):
            spec = plan.spec("cache")
        elif name in ("wkv", "ssm"):
            spec = plan.spec("state")
        else:
            # token-shift tails / conv tails: small, batch-sharded
            dp = plan.dp_axes if plan.dp_axes else None
            spec = P(None, dp, *((None,) * (len(shape) - 2)))
        return NamedSharding(mesh, _fit_spec(spec, shape, mesh))

    return walk(model.cache_spec(suite.global_batch, suite.seq_len))


def build_prefill(model: Model, plan: ShardingPlan):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, plan)

    return prefill_step


def build_decode(model: Model, plan: ShardingPlan, pos: int):
    """One-token decode step at static cache position ``pos``."""

    @torch.no_grad()
    def decode_step(params, batch, cache):
        return model.decode(params, batch, cache, pos, plan)

    return decode_step


def _sharded(variant: str, plan: ShardingPlan, build, out_specs):
    """The step ``build(plan)`` makes (one of the builders above), on
    DTensors: ``zero`` gathers the weights and runs it with the null plan on
    each rank's local rows, and ``out_specs(outputs, inputs)`` wraps what it
    returns as DTensors; the other variants run DTensors through the model."""
    if variant != "zero":
        inner = build(plan)

        def step(*args):
            with dist.implicit_replication():
                return inner(*args)

        return step
    inner = build(ShardingPlan(None, {}, (), None))

    def zero_step(params, *rest):
        out = inner(tree_map(dist.full, params), *(tree_map(dist.local, r) for r in rest))
        return out_specs(out, rest)

    return zero_step


def jit_decode_step(model: Model, mesh, suite: ShapeSuite, variant: str = "baseline"):
    """Decode step at cache position ``suite.seq_len - 1`` + (param, token,
    cache shardings, plan). The cache is updated in place."""
    plan = make_plan(model.cfg, mesh, suite, variant=variant)
    p_sh = param_shardings(model, mesh, variant)
    c_sh = cache_shardings(model, mesh, suite, plan)
    # token batch sharding must respect divisibility (batch=1 long-context
    # cells leave the batch dim unsharded — plan.spec('tokens') encodes that)
    tok_batch_axis = plan.spec("tokens")[0] if len(plan.spec("tokens")) else None
    tok_sh = {"token": NamedSharding(mesh, P(tok_batch_axis))}
    if model.cfg.enc_layers:
        tok_sh["frames"] = NamedSharding(mesh, plan.spec("frames"))
    logits_sh = NamedSharding(mesh, P(tok_batch_axis, None))

    def wrap(out, inputs):  # zero: this rank's rows of the logits; its cache shard was written in place
        return dist.from_local(out[0], mesh, logits_sh.placements), inputs[1]

    step = _sharded(variant, plan, lambda pl: build_decode(model, pl, suite.seq_len - 1), wrap)
    return step, p_sh, tok_sh, c_sh, plan


def jit_prefill_step(model: Model, mesh, suite: ShapeSuite, variant: str = "baseline"):
    """Prefill step + (param, batch shardings, plan); its cache comes back in
    ``cache_shardings``' placements."""
    plan = make_plan(model.cfg, mesh, suite, variant=variant)
    p_sh = param_shardings(model, mesh, variant)
    b_sh = {"tokens": NamedSharding(mesh, plan.spec("tokens"))}
    if model.cfg.n_patches:
        b_sh["patches"] = NamedSharding(mesh, plan.spec("frames"))
    if model.cfg.enc_layers:
        b_sh["frames"] = NamedSharding(mesh, plan.spec("frames"))
    c_sh = cache_shardings(model, mesh, suite, plan)
    logits_sh = NamedSharding(mesh, P(plan.spec("tokens")[0] if len(plan.spec("tokens")) else None, None))

    def wrap(out, _inputs):  # zero: this rank's rows of the logits and of the cache
        last, cache = out
        cache = {k: dist.from_local(v, mesh, c_sh[k].placements) for k, v in cache.items()}
        return dist.from_local(last, mesh, logits_sh.placements), cache

    step = _sharded(variant, plan, lambda pl: build_prefill(model, pl), wrap)
    return step, p_sh, b_sh, plan


def pad_cache(cache: Dict[str, Any], extra: int) -> Dict[str, Any]:
    """Grow the self-attention KV seq dim by ``extra`` slots after prefill.

    Returns new tensors (one copy of the cache); the input is left as it was.
    """

    def pad(name: str, leaf):
        if isinstance(leaf, dict):
            return {k: pad(k, v) for k, v in leaf.items()}
        if name in ("k", "v", "attn_k", "attn_v") and leaf.dim() == 5:
            # F.pad counts dims from the last: (D, KVH, seq)
            return F.pad(leaf, (0, 0, 0, 0, 0, extra))
        return leaf

    return {k: pad(k, v) for k, v in cache.items()}


@torch.no_grad()
def greedy_generate(
    model: Model,
    params,
    prompt: torch.Tensor,  # (B, S) int
    max_new: int,
    plan: ShardingPlan,
) -> torch.Tensor:
    """Eager greedy decoding loop; runs on the device ``prompt`` lies on."""
    B, S = prompt.shape
    last, cache = model.prefill(params, {"tokens": prompt}, plan)
    cache = pad_cache(cache, max_new)
    tokens = [torch.argmax(last, dim=-1).to(torch.int32)]
    for i in range(max_new - 1):
        logits, cache = model.decode(params, {"token": tokens[-1]}, cache, S + i, plan)
        tokens.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(tokens, dim=1)  # (B, max_new)
