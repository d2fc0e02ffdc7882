"""Mixture-of-Experts transformer (deepseek-moe-16b, olmoe-1b-7b).

Expert dispatch is sort-based (megablocks-style), as in the reference: the
assignments of each example are argsorted by expert, grouped into a
static-capacity (E, C, d) tensor, pushed through a batched expert GEMM and
combined back with their gate weights. The reference ``vmap``s dispatch and
combine over the batch; here the batch is a leading dimension of every
tensor, and each example still sorts its own assignments.

Numerics, as the reference's:

* the router is f32. Its product runs in full f32 on the card only while
  ``torch.backends.cuda.matmul.allow_tf32`` is False, which is PyTorch's
  default; this module leaves that flag as it finds it;
* dispatch adds each kept token row into its slot with ``index_add``. A
  dropped assignment adds a zero row at slot ``e * C + 0``, as the
  reference's scatter-add does. No two kept rows share a slot, so the sum is
  exact and the same on every run;
* combine sums a token's k weighted expert rows in bf16 one after the other,
  in the order of the sorted assignments (the reference's scatter order),
  not with atomics, whose order on the card changes from run to run.

Attention goes through ``transformer.attend`` and
``transformer.decode_attention``: the flash kernel (K1, its backward K2/K3
in training) and the decode kernel (K4) on the card.

Under a mesh (the sharded steps of ``runtime/``) the router runs on DTensors
and dispatch and combine on each rank's own examples, as the reference's
``vmap`` over the batch keeps every gather and scatter local to the data
shard: the grouped (B, E, C, d) rows take the plan's ``grouped`` spec
(experts over ``model``, the expert-parallel layout), each rank runs the
expert GEMMs of its experts on its examples against those experts' weights
(gathered over the data axes, as FSDP does), and the combine gathers the
experts' rows back (``_dispatch_combine``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import losses
from repro_torch.models import module as nn
from repro_torch.models import transformer as tfm
from repro_torch.sharding import dist
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]
DispatchInfo = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# router + dispatch
# ---------------------------------------------------------------------------


def router_probs(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> ((T, E) f32 softmax probabilities, (T, E) f32 logits)."""
    logits = torch.matmul(x.float(), p["w_router"].float())
    return torch.softmax(logits, dim=-1), logits


def top_k_gates(probs: torch.Tensor, k: int, renormalize: bool = True):
    """(values, expert ids) of the k largest probabilities of each row."""
    vals, idx = dist.topk_last(probs, k)
    if renormalize:
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return vals, idx


def capacity_of(S: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Token slots of one expert for S tokens: ceil(S k / E cf), at least 8
    and a multiple of 8 (the reference's MXU alignment of the GEMM M dim)."""
    capacity = int(math.ceil(S * top_k / n_experts * capacity_factor))
    return max(8, -(-capacity // 8) * 8)


def sort_dispatch(
    x: torch.Tensor,  # (T, d), or (B, T, d)
    expert_idx: torch.Tensor,  # (T, k) int, or (B, T, k)
    gate_vals: torch.Tensor,  # (T, k) f32, or (B, T, k)
    n_experts: int,
    capacity: int,
    expert_lo: int = 0,
    n_local: Optional[int] = None,
) -> Tuple[torch.Tensor, DispatchInfo]:
    """Group tokens by expert into (E_local, C, d) (or (B, E_local, C, d)).

    Assignments beyond an expert's capacity are dropped, in the order of a
    stable sort by expert id. ``expert_lo``/``n_local`` restrict dispatch to
    the expert range [expert_lo, expert_lo + n_local); assignments outside it
    are masked out. Returns the grouped rows and ``(st, sg, slot, keep)``,
    each (T k,) (or (B, T k)): the token, gate, slot and kept flag of every
    assignment in sorted order.
    """
    if x.dim() == 2:
        grouped, info = sort_dispatch(x[None], expert_idx[None], gate_vals[None], n_experts, capacity,
                                      expert_lo, n_local)
        return grouped[0], tuple(t[0] for t in info)
    if n_local is None:
        n_local = n_experts
    B, T, k = expert_idx.shape
    d = x.shape[-1]
    dev = x.device
    flat_e = expert_idx.reshape(B, T * k).long()
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)  # token id per assignment
    flat_g = gate_vals.reshape(B, T * k)

    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sg = torch.gather(flat_g, 1, order)

    # position of each assignment within its expert's run
    counts = torch.zeros((B, n_experts), dtype=torch.long, device=dev).scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(T * k, device=dev) - torch.gather(starts, 1, se)
    local_e = se - expert_lo
    keep = (pos < capacity) & (local_e >= 0) & (local_e < n_local)
    local_e = local_e.clamp(0, n_local - 1)
    slot = local_e * capacity + torch.where(pos < capacity, pos, 0)

    rows = torch.gather(x, 1, st[..., None].expand(B, T * k, d))
    rows = torch.where(keep[..., None], rows, torch.zeros((), dtype=x.dtype, device=dev))
    base = (torch.arange(B, device=dev) * (n_local * capacity))[:, None]
    grouped = torch.zeros((B * n_local * capacity, d), dtype=x.dtype, device=dev)
    grouped = grouped.index_add(0, (slot + base).reshape(-1), rows.reshape(-1, d))
    return grouped.reshape(B, n_local, capacity, d), (st, sg, slot, keep)


def sort_combine(expert_out: torch.Tensor, scatter_info: DispatchInfo, T: int) -> torch.Tensor:
    """(E, C, d) (or (B, E, C, d)) expert rows back to (T, d) (or (B, T, d)).

    A token's k weighted rows are added in the order of the sorted
    assignments, each add rounded to the rows' type, so the result is the
    same on every run.
    """
    if expert_out.dim() == 3:
        return sort_combine(expert_out[None], tuple(t[None] for t in scatter_info), T)[0]
    st, sg, slot, keep = scatter_info
    B, E, C, d = expert_out.shape
    n = st.shape[1]
    k = n // T
    rows = torch.gather(expert_out.reshape(B, E * C, d), 1, slot[..., None].expand(B, n, d))
    rows = rows * (sg * keep.to(sg.dtype))[..., None].to(rows.dtype)
    # every token has k assignments: order them by token, keeping the sorted order within one
    by_token = torch.argsort(st, dim=-1, stable=True)
    rows = torch.gather(rows, 1, by_token[..., None].expand(B, n, d)).reshape(B, T, k, d)
    out = torch.zeros((B, T, d), dtype=expert_out.dtype, device=expert_out.device)
    for j in range(k):
        out = out + rows[:, :, j]
    return out


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e fraction_e * mean_prob_e.

    The assignments are counted by comparing them with each expert id and
    summing, a count of static shape: ``bincount``'s output depends on the
    data, so it cannot be traced on fake tensors, and DTensor has no rule
    for it."""
    experts = torch.arange(n_experts, device=expert_idx.device)
    assign = (expert_idx.reshape(-1, 1).long() == experts).sum(0).float()
    frac = assign / assign.sum().clamp_min(1.0)
    mean_p = probs.mean(dim=0)
    return n_experts * (frac * mean_p).sum()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def init_moe_ffn(cfg: ModelConfig, gen: torch.Generator, device, stack: Tuple[int, ...] = ()) -> Params:
    """The MoE FFN's leaves of one layer or of a stack (``stack`` leads every
    shape). The reference initializes the expert weights of one layer as
    (E, d, f) arrays through ``fan_in_init``, which takes the fan-in from the
    leading dim: E. So their std is 1/sqrt(E) (scaled for ``e_down``), kept
    here."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    bf16 = torch.bfloat16
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    p: Params = {
        "w_router": nn.fan_in_init(gen, (*stack, d, E), torch.float32, device),
        "e_gate": nn.trunc_normal(gen, (*stack, E, d, f), 1.0 / math.sqrt(E), bf16, device),
        "e_up": nn.trunc_normal(gen, (*stack, E, d, f), 1.0 / math.sqrt(E), bf16, device),
        "e_down": nn.trunc_normal(gen, (*stack, E, f, d), out_scale / math.sqrt(E), bf16, device),
    }
    if m.n_shared:
        fs = m.n_shared * m.d_expert
        p["shared"] = {
            "w_gate": init((*stack, d, fs)),
            "w_up": init((*stack, d, fs)),
            "w_down": init((*stack, fs, d), scale=out_scale),
        }
    return p


def _expert_mlp(p: Params, grouped: torch.Tensor) -> torch.Tensor:
    """(B, E, C, d) -> (B, E, C, d) batched swiglu expert GEMMs."""
    gate_h = torch.einsum("becd,edf->becf", grouped, p["e_gate"].to(grouped.dtype))
    up_h = torch.einsum("becd,edf->becf", grouped, p["e_up"].to(grouped.dtype))
    h = F.silu(gate_h.float()).to(up_h.dtype) * up_h
    return torch.einsum("becf,efd->becd", h, p["e_down"].to(h.dtype))


def moe_ffn(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    plan: ShardingPlan,
    capacity_factor: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN: route, dispatch per example, expert GEMMs, combine, plus
    the shared experts where the config has them. Returns (y, aux) with the
    load-balance loss and the router z-loss of this layer."""
    m = cfg.moe
    if capacity_factor is None:
        capacity_factor = m.capacity_factor
    B, S, d = x.shape
    probs, logits = router_probs(p, dist.rows_flattenable(x).reshape(B * S, d))
    gates, eidx = top_k_gates(probs, m.top_k)
    capacity = capacity_of(S, m.top_k, m.n_experts, capacity_factor)
    y = _dispatch_combine(cfg, p, x, eidx.reshape(B, S, m.top_k), gates.reshape(B, S, m.top_k), capacity, plan)

    if m.n_shared:
        y = y + tfm._mlp(cfg, p["shared"], x, plan)

    aux = {
        "aux_loss": load_balance_loss(probs, eidx, m.n_experts),
        "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    return y, aux


def _dispatch_combine(cfg: ModelConfig, p: Params, x, eidx, gates, capacity: int, plan: ShardingPlan):
    """Dispatch (B, S, d) rows to the experts, run their GEMMs and combine
    them back to (B, S, d). On DTensors each rank runs dispatch and combine
    on its own examples (the batch over the data axes, the rest whole), the
    grouped rows take the ``grouped`` spec and each rank runs the GEMMs of the
    experts it holds, whose weights come gathered over the other axes: in
    backward their local gradients are summed over the axes that split the
    examples (``dist.local_operand``)."""
    m, S = cfg.moe, x.shape[1]
    if not dist.is_dtensor(x):
        grouped, info = sort_dispatch(x, eidx, gates, m.n_experts, capacity, 0, m.n_experts)
        grouped = plan.act(grouped, "grouped")
        out = plan.act(_expert_mlp(p, grouped), "grouped")
        return sort_combine(out, info, S)
    mesh = x.device_mesh
    rows = dist.kernel_placements(mesh, x.shape[0], (), 0, None)
    grouped, info = sort_dispatch(*(dist.to_local_as(t, mesh, rows) for t in (x, eidx, gates)),
                                  m.n_experts, capacity, 0, m.n_experts)
    grouped = plan.act(dist.from_local(grouped, mesh, rows), "grouped")
    # the expert dim: dim 1 of the grouped rows, dim 0 of the stacked weights
    weights = {k: dist.local_operand(p[k], grouped, {1: 0}) for k in ("e_gate", "e_up", "e_down")}
    out = plan.act(dist.from_local(_expert_mlp(weights, grouped.to_local()), mesh, grouped.placements), "grouped")
    return dist.from_local(sort_combine(dist.to_local_as(out, mesh, rows), info, S), mesh, rows)


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random parameters from a seeded generator, made on ``device``.

    The reference's tree, shapes, types and distributions, layers stacked on
    a leading ``L`` dim; not its bits. ``gen`` must live on ``device``.
    """
    bf16 = torch.bfloat16
    L, d = cfg.n_layers, cfg.d_model
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    layers = {
        "attn_norm": nn.rmsnorm_init(d, device=device, stack=(L,)),
        "attn": tfm.init_attn(cfg, init, device, (L,)),
        "mlp_norm": nn.rmsnorm_init(d, device=device, stack=(L,)),
        "moe": init_moe_ffn(cfg, gen, device, (L,)),
    }
    return {
        "embed": {"table": nn.trunc_normal(gen, (cfg.padded_vocab, d), 1.0 / d**0.5, bf16, device)},
        "layers": layers,
        "final_norm": nn.rmsnorm_init(d, device=device),
        "lm_head": {"w_lm": init((d, cfg.padded_vocab))},
    }


def block_fwd(cfg: ModelConfig, plan: ShardingPlan, carry, lp: Params):
    x, aux_acc = carry
    x = x + plan.act(tfm._attn_train(cfg, lp["attn"], tfm._norm(cfg, lp["attn_norm"], x), plan), "hidden")
    y, aux = moe_ffn(cfg, lp["moe"], tfm._norm(cfg, lp["mlp_norm"], x), plan)
    x = x + plan.act(y, "hidden")
    aux_acc = {
        "aux_loss": aux_acc["aux_loss"] + aux["aux_loss"],
        "router_z": aux_acc["router_z"] + aux["router_z"],
    }
    return x, aux_acc


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Token ids (B, S) -> (logits (B, S, V), aux summed over the layers)."""
    h = tfm.embed_tokens(cfg, params, tokens, plan)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    body = functools.partial(block_fwd, cfg, plan)
    h, aux = nn.scan_layers(body, (h, {"aux_loss": zero, "router_z": zero}), params["layers"], remat=cfg.remat)
    logits = tfm.logits_fn(cfg, params, h, plan)
    return plan.act(logits, "logits"), aux


# ---------------------------------------------------------------------------
# serving path (KV cache identical to dense; MoE FFN applied per step)
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Full-sequence forward that also returns the populated KV cache.

    Returns (last-position logits (B, V), cache).
    """
    B, S = tokens.shape
    h = tfm.embed_tokens(cfg, params, tokens, plan)
    positions = torch.arange(S, device=h.device)
    rope = nn.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)  # once for all layers
    # under a mesh, DTensors in the cache plan's placements from the start
    cache = {name: plan.new(shape, dt, "cache", h.device) for name, (shape, dt) in tfm.cache_spec(cfg, B, S).items()}

    for i, lp in enumerate(nn.unbind_layers(params["layers"])):
        xn = tfm._norm(cfg, lp["attn_norm"], h)
        qkv = tfm._qkv(cfg, lp["attn"], xn, plan, positions=positions, tables=rope)
        out = tfm.attend(qkv, block_k=cfg.attn_block_k)
        h = h + plan.act(nn.dense_apply({"w": lp["attn"]["wo"]}, out), "hidden")
        y, _ = moe_ffn(cfg, lp["moe"], tfm._norm(cfg, lp["mlp_norm"], h), plan)
        h = h + plan.act(y, "hidden")
        tfm.write_cache(qkv, cache["k"], cache["v"], i)

    cache = {"k": plan.act(cache["k"], "cache"), "v": plan.act(cache["v"], "cache")}
    last = tfm.logits_fn(cfg, params, h[:, -1:, :], plan)[:, 0, :]
    return plan.act(last, "last_logits"), cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # (B,) int
    cache: Dict[str, torch.Tensor],
    pos: Union[int, torch.Tensor],
    plan: ShardingPlan,
):
    """One decode step against the KV cache. **Updates the cache in place**,
    as the transformer's ``decode_step`` does; clone a cache that must be reused."""
    B = token.shape[0]
    pos = int(pos)
    h = plan.act(nn.embedding_apply(params["embed"], token[:, None]), "decode_hidden")
    pos_arr = torch.tensor([pos], dtype=torch.int32, device=token.device)
    kv_len = pos_arr + 1  # one device scalar shared by every layer's attention
    rope = nn.rope_tables(pos_arr, cfg.resolved_head_dim, cfg.rope_theta)

    for i, lp in enumerate(nn.unbind_layers(params["layers"])):
        kc, vc = cache["k"][i], cache["v"][i]
        xn = tfm._norm(cfg, lp["attn_norm"], h)
        q, k, v, _ = tfm._qkv(cfg, lp["attn"], xn, plan, positions=pos_arr, tables=rope)
        dist.write_rows(kc, 1, pos, k)
        dist.write_rows(vc, 1, pos, v)
        out = tfm.decode_attention(q, kc, vc, kv_len=kv_len)
        h = h + plan.act(nn.dense_apply({"w": lp["attn"]["wo"]}, out.reshape(B, 1, -1)), "decode_hidden")
        y, _ = moe_ffn(cfg, lp["moe"], tfm._norm(cfg, lp["mlp_norm"], h), plan)
        h = h + plan.act(y, "decode_hidden")

    logits = tfm.logits_fn(cfg, params, h, plan)[:, 0, :]
    new_cache = {"k": plan.act(cache["k"], "cache"), "v": plan.act(cache["v"], "cache")}
    return plan.act(logits, "last_logits"), new_cache


def _build_moe(cfg: ModelConfig):
    """The ``Model`` facade of the moe family (``model_api`` registers it)."""
    from repro_torch.models.model_api import Model, _input_specs

    def init(gen: torch.Generator, device="cuda"):
        return init_params(cfg, gen, resolve_device(device))

    def loss(params, batch, plan: ShardingPlan):
        logits, aux = forward(cfg, params, batch["tokens"], plan)
        base, metrics = losses.softmax_cross_entropy(logits, batch["labels"])
        m = cfg.moe
        total = (
            base
            + m.router_aux_coef * aux["aux_loss"] / cfg.n_layers
            + m.router_z_coef * aux["router_z"] / cfg.n_layers
        )
        return total, dict(metrics, aux_loss=aux["aux_loss"] / cfg.n_layers)

    return Model(
        cfg=cfg,
        init=init,
        loss=loss,
        prefill=lambda params, batch, plan: prefill(cfg, params, batch["tokens"], plan),
        decode=lambda params, batch, cache, pos, plan: decode_step(
            cfg, params, batch["token"], cache, pos, plan
        ),
        cache_spec=lambda b, s: tfm.cache_spec(cfg, b, s),
        input_specs=lambda suite: _input_specs(cfg, suite),
    )
