"""Dense GQA decoder-only transformer (stablelm/qwen2/granite/llama3 + the
llava backbone). Layer parameters are stacked on a leading ``L`` dim, as the
reference stacks them, and depth is a Python loop over that dim.

``forward`` is differentiable (the flash kernels have a backward) and honours
``cfg.remat`` as the reference does; ``prefill`` and ``decode_step`` are the
serving path and are called under ``torch.no_grad()``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as nn
from repro_torch.models.attention import attend, decode_attention, heads, write_cache
from repro_torch.sharding import dist
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_init(cfg: ModelConfig, device, stack: Tuple[int, ...] = ()) -> Params:
    init = nn.rmsnorm_init if cfg.norm == "rmsnorm" else nn.layernorm_init
    return init(cfg.d_model, device=device, stack=stack)


def init_attn(cfg: ModelConfig, init, device, stack: Tuple[int, ...] = ()) -> Params:
    """The attention leaves of one layer, or of a stack of layers (``stack``
    leads every shape), as the reference's ``init_attn_layer``. ``init`` is
    ``nn.fan_in_init`` bound to a generator, bf16 and ``device``."""
    bf16 = torch.bfloat16
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn: Params = {
        "wq": init((*stack, d, cfg.n_heads * hd)),
        "wk": init((*stack, d, cfg.n_kv_heads * hd)),
        "wv": init((*stack, d, cfg.n_kv_heads * hd)),
        "wo": init((*stack, cfg.n_heads * hd, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((*stack, cfg.n_heads * hd), dtype=bf16, device=device)
        attn["bk"] = torch.zeros((*stack, cfg.n_kv_heads * hd), dtype=bf16, device=device)
        attn["bv"] = torch.zeros((*stack, cfg.n_kv_heads * hd), dtype=bf16, device=device)
    return attn


def init_mlp(cfg: ModelConfig, init, stack: Tuple[int, ...] = ()) -> Params:
    """The MLP leaves of one layer or a stack, as the reference's ``init_mlp_layer``."""
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    if cfg.act == "swiglu":
        return {
            "w_gate": init((*stack, d, f)),
            "w_up": init((*stack, d, f)),
            "w_down": init((*stack, f, d), scale=out_scale),
        }
    return {"w_up": init((*stack, d, f)), "w_down": init((*stack, f, d), scale=out_scale)}


def init_block(cfg: ModelConfig, init, device, stack: Tuple[int, ...] = ()) -> Params:
    """One block's leaves (or a stack's), as the reference's ``init_block``."""
    attn, mlp = init_attn(cfg, init, device, stack), init_mlp(cfg, init, stack)
    return {
        "attn_norm": _norm_init(cfg, device, stack),
        "attn": attn,
        "mlp_norm": _norm_init(cfg, device, stack),
        "mlp": mlp,
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random parameters from a seeded generator, made on ``device``.

    Same tree, shapes and types as the reference's ``init_params``, same
    distributions (truncated normal with fan-in scaling); not the same bits,
    since the two frameworks draw different numbers from a seed. ``gen`` must
    live on ``device``.
    """
    bf16 = torch.bfloat16
    d = cfg.d_model
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    layers = init_block(cfg, init, device, (cfg.n_layers,))
    params: Params = {
        "embed": {
            "table": nn.trunc_normal(gen, (cfg.padded_vocab, d), 1.0 / d**0.5, bf16, device)
        },
        "layers": layers,
        "final_norm": _norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w_lm": init((d, cfg.padded_vocab))}
    if cfg.n_patches:
        params["patch_proj"] = {"w_in": init((d, d))}
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return nn.rmsnorm_apply(p, x)
    return nn.layernorm_apply(p, x)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    if cfg.act == "swiglu":
        gate = nn.dense_apply({"w": p["w_gate"]}, x)
        up = nn.dense_apply({"w": p["w_up"]}, x)
        h = F.silu(gate.float()).to(up.dtype) * up
    else:
        h = F.gelu(nn.dense_apply({"w": p["w_up"]}, x).float(), approximate="tanh").to(x.dtype)
    h = plan.act(h, "ffn")
    return nn.dense_apply({"w": p["w_down"]}, h)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, plan: ShardingPlan, *, causal: bool = True,
         positions: Optional[torch.Tensor] = None, tables=None):
    """The q, k, v projections of ``x`` as the attention reads them, RoPE'd
    at ``positions`` (default rows 0..S-1) or from their ``tables``
    (``attention.heads``)."""
    q = nn.dense_apply({"w": p["wq"], **({"b": p["bq"]} if "bq" in p else {})}, x)
    k = nn.dense_apply({"w": p["wk"], **({"b": p["bk"]} if "bk" in p else {})}, x)
    v = nn.dense_apply({"w": p["wv"], **({"b": p["bv"]} if "bv" in p else {})}, x)
    return heads(plan, q, k, v, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, causal=causal,
                 theta=cfg.rope_theta, positions=positions, tables=tables)


def _attn_train(
    cfg: ModelConfig, p: Params, x: torch.Tensor, plan: ShardingPlan, *, causal=True
) -> torch.Tensor:
    out = plan.wo_input(attend(_qkv(cfg, p, x, plan, causal=causal), block_k=cfg.attn_block_k))
    return nn.dense_apply({"w": p["wo"]}, out)


def block_fwd(
    cfg: ModelConfig, plan: ShardingPlan, x: torch.Tensor, lp: Params
) -> torch.Tensor:
    att = _attn_train(cfg, lp["attn"], _norm(cfg, lp["attn_norm"], x), plan)
    x = x + plan.act(att, "hidden")
    mlp = _mlp(cfg, lp["mlp"], _norm(cfg, lp["mlp_norm"], x), plan)
    return plan.act(x + plan.act(mlp, "hidden"), "hidden")


def logits_fn(cfg: ModelConfig, params: Params, h: torch.Tensor, plan: ShardingPlan):
    h = _norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = dist.grad_as(F.linear(dist.rows_flattenable(h), params["embed"]["table"].to(torch.bfloat16)))
    else:
        logits = nn.dense_apply({"w": params["lm_head"]["w_lm"]}, h)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits.float() / cfg.logit_softcap)
    return mask_pad_logits(cfg, logits)


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Mask the vocab-pad columns to -1e30 (a new tensor; the input is kept)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < cfg.vocab, logits, -1e30)


def embed_tokens(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    plan: ShardingPlan,
    patches: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    h = nn.embedding_apply(params["embed"], tokens)
    if patches is not None:
        # llava-style stub frontend: project precomputed patch embeddings and
        # overwrite the first n_patches token slots with them.
        pe = nn.dense_apply({"w": params["patch_proj"]["w_in"]}, patches.to(torch.bfloat16))
        n = pe.shape[1]
        h = torch.cat([pe, h[:, n:, :]], dim=1)
    return plan.act(h, "hidden")


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    plan: ShardingPlan,
    patches: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token ids (B, S) -> logits (B, S, V)."""
    h = embed_tokens(cfg, params, tokens, plan, patches)
    body = functools.partial(block_fwd, cfg, plan)
    h = nn.scan_layers(body, h, params["layers"], remat=cfg.remat)
    logits = logits_fn(cfg, params, h, plan)
    return plan.act(logits, "logits")


# ---------------------------------------------------------------------------
# KV-cache serving path
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shape and type of each cache leaf, as ``(shape, dtype)`` pairs."""
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, (shape, dtype) in cache_spec(cfg, batch, max_len).items()
    }


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    plan: ShardingPlan,
    patches: Optional[torch.Tensor] = None,
):
    """Full-sequence forward that also returns the populated KV cache.

    Returns (last-position logits (B, V), cache).
    """
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens, plan, patches)
    positions = torch.arange(S, device=h.device)
    rope = nn.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)  # once for all layers
    # under a mesh, DTensors in the cache plan's placements from the start
    cache = {name: plan.new(shape, dt, "cache", h.device) for name, (shape, dt) in cache_spec(cfg, B, S).items()}

    for i in range(cfg.n_layers):
        lp = nn.layer_params(params["layers"], i)
        xn = _norm(cfg, lp["attn_norm"], h)
        qkv = _qkv(cfg, lp["attn"], xn, plan, positions=positions, tables=rope)
        out = attend(qkv, block_k=cfg.attn_block_k)
        # each row-parallel product's partial sums reduced before they join
        # the residual, as in ``block_fwd``: a partial residual would make
        # the next norm's output partial, and the MLP's products whole
        h = h + plan.act(nn.dense_apply({"w": lp["attn"]["wo"]}, out), "hidden")
        h = h + plan.act(_mlp(cfg, lp["mlp"], _norm(cfg, lp["mlp_norm"], h), plan), "hidden")
        # store rope'd keys so decode never re-rotates the cache
        write_cache(qkv, cache["k"], cache["v"], i)

    cache = {"k": plan.act(cache["k"], "cache"), "v": plan.act(cache["v"], "cache")}
    last = logits_fn(cfg, params, h[:, -1:, :], plan)[:, 0, :]
    return plan.act(last, "last_logits"), cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # (B,) int
    cache: Dict[str, torch.Tensor],
    pos: Union[int, torch.Tensor],  # current length (tokens already in cache)
    plan: ShardingPlan,
):
    """One decode step against the KV cache.

    **Updates the cache in place**: slot ``pos`` of every layer of
    ``cache["k"]`` and ``cache["v"]`` is overwritten and the same dict's
    tensors are returned (the reference returns fresh arrays from
    ``dynamic_update_slice``). Clone a cache that must be reused.
    """
    B = token.shape[0]
    pos = int(pos)
    dev = token.device
    h = nn.embedding_apply(params["embed"], token[:, None])
    h = plan.act(h, "decode_hidden")
    pos_arr = torch.tensor([pos], dtype=torch.int32, device=dev)
    kv_len = pos_arr + 1  # one device scalar shared by every layer's attention
    rope = nn.rope_tables(pos_arr, cfg.resolved_head_dim, cfg.rope_theta)  # once for all layers

    for i in range(cfg.n_layers):
        lp = nn.layer_params(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        xn = _norm(cfg, lp["attn_norm"], h)
        q, k, v, _ = _qkv(cfg, lp["attn"], xn, plan, positions=pos_arr, tables=rope)
        dist.write_rows(kc, 1, pos, k)
        dist.write_rows(vc, 1, pos, v)
        out = decode_attention(q, kc, vc, kv_len=kv_len)
        out = plan.act(out, "decode_heads")
        h = h + plan.act(nn.dense_apply({"w": lp["attn"]["wo"]}, out.reshape(B, 1, -1)), "decode_hidden")
        h = h + plan.act(_mlp(cfg, lp["mlp"], _norm(cfg, lp["mlp_norm"], h), plan), "decode_hidden")

    new_cache = {"k": plan.act(cache["k"], "cache"), "v": plan.act(cache["v"], "cache")}
    logits = logits_fn(cfg, params, h, plan)[:, 0, :]
    return plan.act(logits, "last_logits"), new_cache
