"""Mamba2 (SSD) blocks and the zamba2-7b hybrid (Mamba2 backbone + one
*shared* GQA attention block applied before every ``attn_every``-th layer).

SSD recurrence (per head h, state h_t in R^{P x N}, scalar decay a_t):
  h_t = a_t * h_{t-1} + (dt_t x_t) outer B_t
  y_t = h_t @ C_t + D * x_t
Prefill and training use the chunked form (bounded pairwise decays, a loop
over chunks); decode carries the (B, H, P, N) state and a (B, d_conv-1,
conv_channels) conv tail, so its cost does not grow with the sequence.

The chunked scan has no kernel of its own, here as in the reference (where
it is XLA einsums under ``lax.scan``): it is plain PyTorch, a loop over the
chunks of each layer. The shared attention block goes through
``transformer.flash_attention`` and ``transformer.decode_attention``: the
flash kernel (K1) and the decode kernel (K4) on the card, at zamba2's head
dim of 112.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import losses
from repro_torch.models import module as nn
from repro_torch.models import transformer as tfm
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # (B, T, H, P) inner activations (dt-scaled inside)
    dt: torch.Tensor,  # (B, T, H) softplus'd step sizes
    A: torch.Tensor,  # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, T, N) input projections (single group)
    Cm: torch.Tensor,  # (B, T, N)
    state0: torch.Tensor,  # (B, H, P, N)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,P) f32, final state (B,H,P,N) f32)."""
    B_, T, H, P = x.shape
    N = Bm.shape[-1]
    assert T % chunk == 0
    n = T // chunk

    la_full = dt * A[None, None, :]  # (B,T,H) log-decay per step, <= 0
    xr = x.float().reshape(B_, n, chunk, H, P).permute(1, 0, 3, 2, 4)
    dtr = dt.float().reshape(B_, n, chunk, H).permute(1, 0, 3, 2)
    lar = la_full.float().reshape(B_, n, chunk, H).permute(1, 0, 3, 2)
    Br = Bm.float().reshape(B_, n, chunk, N).permute(1, 0, 2, 3)
    Cr = Cm.float().reshape(B_, n, chunk, N).permute(1, 0, 2, 3)
    # xr/dtr/lar: (n,B,H,C[,P]); Br/Cr: (n,B,C,N)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))  # s <= t inclusive

    S = state0.float()
    ys: List[torch.Tensor] = []
    for xb, dtb, lab, Bb, Cb in zip(xr, dtr, lar, Br, Cr):
        cla = torch.cumsum(lab, dim=-1)  # (B,H,C) inclusive
        # pairwise decay exp(cla_t - cla_s) for s <= t (bounded <= 1); the
        # mask comes before the exp, or diff above the diagonal overflows
        diff = cla[:, :, :, None] - cla[:, :, None, :]  # (B,H,C,C)
        decay = torch.exp(torch.where(tri, diff, -torch.inf))
        cb = torch.einsum("btn,bsn->bts", Cb, Bb)  # (B,C,C)
        scores = decay * cb[:, None, :, :]  # (B,H,C,C)
        xdt = xb * dtb[..., None]  # dt-weighted inputs
        y = torch.einsum("bhts,bhsp->bhtp", scores, xdt)
        # cross-chunk: y += exp(cla_t) * (C_t . S)
        y = y + torch.exp(cla)[..., None] * torch.einsum("bhpn,btn->bhtp", S, Cb)
        # state: S' = exp(cla[-1]) S + sum_s exp(cla[-1]-cla_s) (dt_s x_s) outer B_s
        last = cla[:, :, -1:]  # (B,H,1)
        w = torch.exp(last - cla)  # (B,H,C)
        S = torch.exp(last)[..., None] * S + torch.einsum("bhsp,bsn->bhpn", xdt * w[..., None], Bb)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B_, T, H, P)
    return y, S


def ssd_step(x, dt, A, Bm, Cm, state):
    """Single step. x:(B,H,P), dt:(B,H), Bm/Cm:(B,N), state (B,H,P,N)."""
    a = torch.exp((dt * A[None, :]).float())  # (B,H)
    xdt = (x * dt[..., None]).float()
    upd = torch.einsum("bhp,bn->bhpn", xdt, Bm.float())
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    return y, state


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------


def _inner(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def init_mamba_block(cfg: ModelConfig, gen: torch.Generator, device, stack: Tuple[int, ...] = ()) -> Params:
    """One mamba2 block's leaves, or a stack's (``stack`` leads every shape)."""
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    d_inner, H, P, N = _inner(cfg)
    conv_ch = d_inner + 2 * N  # x, B, C go through the short conv
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))  # A = -exp(A_log)
    return {
        "norm": nn.rmsnorm_init(d, device=device, stack=stack),
        # fused in-proj: [z, x, B, C, dt]
        "w_in": init((*stack, d, 2 * d_inner + 2 * N + H)),
        "conv_w": nn.trunc_normal(gen, (*stack, cfg.ssm.d_conv, conv_ch), 0.1, bf16, device),
        "conv_b": torch.zeros((*stack, conv_ch), dtype=bf16, device=device),
        "A_log": a_log.expand(*stack, H).clone(),
        "D": torch.ones((*stack, H), dtype=f32, device=device),
        "dt_bias": torch.zeros((*stack, H), dtype=f32, device=device),
        "out_norm": nn.rmsnorm_init(d_inner, device=device, stack=stack),
        "w_out": init((*stack, d_inner, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, H, P, N = _inner(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)  # z, x, B, C, dt


def _causal_conv_seq(w, b, x, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T. x: (B,T,C); w: (K,C). Returns (y, new_tail)."""
    K = w.shape[0]
    T = x.shape[1]
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device) if tail is None else tail
    xp = torch.cat([pad, x], dim=1)
    # sum_k w[k] * x[t - (K-1) + k], in x's type, term by term
    y = xp[:, 0:T, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i : i + T, :] * w[i][None, None, :]
    y = y + b[None, None, :]
    return F.silu(y.float()).to(x.dtype), xp[:, -(K - 1) :, :]


def mamba_seq(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B,T,d)
    plan: ShardingPlan,
    state0: torch.Tensor,
    conv_tail: Optional[torch.Tensor] = None,
):
    """A mamba2 block over a sequence: returns (out (B,T,d), state, conv tail)."""
    B, T, d = x.shape
    d_inner, H, P, N = _inner(cfg)
    xn = nn.rmsnorm_apply(p["norm"], x)
    proj = nn.dense_apply({"w": p["w_in"]}, xn)
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_tail = _causal_conv_seq(p["conv_w"], p["conv_b"], conv_in, conv_tail)
    xin, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    xh = plan.act(xin.reshape(B, T, H, P), "heads")
    y, state = ssd_chunked(xh, dtv, A, Bc, Cc, state0, chunk=cfg.ssm.chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, T, d_inner).to(torch.bfloat16)
    y = nn.rmsnorm_apply(p["out_norm"], y) * F.silu(z.float()).to(torch.bfloat16)
    out = nn.dense_apply({"w": p["w_out"]}, y)
    return out, state, new_tail


def mamba_step(cfg: ModelConfig, p: Params, x, state, conv_tail):
    """One token through a mamba2 block. x: (B,d); conv_tail: (B, K-1, C).
    Returns (out (B,d), state, conv tail)."""
    B, d = x.shape
    d_inner, H, P, N = _inner(cfg)
    xn = nn.rmsnorm_apply(p["norm"], x)
    proj = nn.dense_apply({"w": p["w_in"]}, xn)
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)  # (B,C)
    window = torch.cat([conv_tail, conv_in[:, None, :]], dim=1)  # (B,K,C)
    # the window's dot with the taps, summed in f32 and rounded once
    y = (window.float() * p["conv_w"].float()[None]).sum(dim=1).to(window.dtype) + p["conv_b"]
    y = F.silu(y.float()).to(x.dtype)
    xin, Bc, Cc = torch.split(y, [d_inner, N, N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    yh, state = ssd_step(xin.reshape(B, H, P), dtv, A, Bc, Cc, state)
    yh = yh + p["D"][None, :, None] * xin.reshape(B, H, P).float()
    yh = yh.reshape(B, d_inner).to(torch.bfloat16)
    yh = nn.rmsnorm_apply(p["out_norm"], yh) * F.silu(z.float()).to(torch.bfloat16)
    return nn.dense_apply({"w": p["w_out"]}, yh), state, window[:, 1:, :]


# ---------------------------------------------------------------------------
# zamba2 hybrid assembly
# ---------------------------------------------------------------------------


def _group_sizes(cfg: ModelConfig) -> List[int]:
    """Layer groups: shared attention applied before each group."""
    k = cfg.attn_every
    n = cfg.n_layers
    if k <= 0:
        return [n]
    full, rem = divmod(n, k)
    return [k] * full + ([rem] if rem else [])


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random parameters from a seeded generator, made on ``device``.

    The reference's tree, shapes, types and distributions, layers stacked on
    a leading ``L`` dim; the shared attention block (``shared_attn``) is one
    unstacked transformer block. Not the reference's bits. ``gen`` must live
    on ``device``.
    """
    bf16 = torch.bfloat16
    d = cfg.d_model
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    layers = init_mamba_block(cfg, gen, device, (cfg.n_layers,))
    params: Params = {
        "embed": {"table": nn.trunc_normal(gen, (cfg.padded_vocab, d), 1.0 / d**0.5, bf16, device)},
        "layers": layers,
        "final_norm": nn.rmsnorm_init(d, device=device),
        "lm_head": {"w_lm": init((d, cfg.padded_vocab))},
    }
    if cfg.attn_every:
        params["shared_attn"] = tfm.init_block(cfg, init, device)
    return params


def _zero_state(cfg: ModelConfig, B: int, device) -> torch.Tensor:
    d_inner, H, P, N = _inner(cfg)
    return torch.zeros((B, H, P, N), dtype=torch.float32, device=device)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Token ids (B, T) -> logits (B, T, V)."""
    h = plan.act(nn.embedding_apply(params["embed"], tokens), "hidden")
    state0 = _zero_state(cfg, tokens.shape[0], h.device)

    def mamba_body(x, lp):
        y, _, _ = mamba_seq(cfg, lp, x, plan, state0)
        return plan.act(x + y, "hidden")

    start = 0
    for size in _group_sizes(cfg):
        if cfg.attn_every:
            h = tfm.block_fwd(cfg, plan, h, params["shared_attn"])
        group = nn.slice_layers(params["layers"], start, start + size)
        h = nn.scan_layers(mamba_body, h, group, remat=cfg.remat)
        start += size
    return plan.act(tfm.logits_fn(cfg, params, h, plan), "logits")


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shape and type of each cache leaf, as ``(shape, dtype)`` pairs: the
    SSM states and conv tails of every layer, and the shared block's K/V of
    every application (grown by ``pad_cache``)."""
    d_inner, H, P, N = _inner(cfg)
    conv_ch = d_inner + 2 * N
    L = cfg.n_layers
    spec = {
        "ssm": ((L, batch, H, P, N), torch.float32),
        "conv": ((L, batch, cfg.ssm.d_conv - 1, conv_ch), torch.bfloat16),
    }
    if cfg.attn_every:
        shape = (len(_group_sizes(cfg)), batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        spec["attn_k"] = (shape, torch.bfloat16)
        spec["attn_v"] = (shape, torch.bfloat16)
    return spec


def _attn_prefill_block(cfg, lp, x, plan, positions, rope=None):
    """Shared-attn block forward that also returns rope'd K/V for the cache."""
    B, S, _ = x.shape
    xn = tfm._norm(cfg, lp["attn_norm"], x)
    q, k, v = tfm._qkv(cfg, lp["attn"], xn, plan)
    q = nn.apply_rope(q, positions, cfg.rope_theta, tables=rope)
    kr = nn.apply_rope(k, positions, cfg.rope_theta, tables=rope)
    out = tfm.flash_attention(q, kr, v, causal=True, block_k=cfg.attn_block_k)
    x = x + nn.dense_apply({"w": lp["attn"]["wo"]}, out.reshape(B, S, -1))
    x = x + tfm._mlp(cfg, lp["mlp"], tfm._norm(cfg, lp["mlp_norm"], x), plan)
    return plan.act(x, "hidden"), kr.to(torch.bfloat16), v.to(torch.bfloat16)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Full-sequence forward that also returns the state cache and the shared
    block's K/V. Returns (last-position logits (B, V), cache)."""
    B, T = tokens.shape
    h = plan.act(nn.embedding_apply(params["embed"], tokens), "hidden")
    state0 = _zero_state(cfg, B, h.device)
    positions = torch.arange(T, device=h.device)
    rope = nn.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    cache = {name: torch.empty(shape, dtype=dt, device=h.device)
             for name, (shape, dt) in cache_spec(cfg, B, T).items()}

    layers = nn.unbind_layers(params["layers"])
    start = 0
    for g, size in enumerate(_group_sizes(cfg)):
        if cfg.attn_every:
            h, kr, v = _attn_prefill_block(cfg, params["shared_attn"], h, plan, positions, rope)
            cache["attn_k"][g].copy_(kr)
            cache["attn_v"][g].copy_(v)
        for i in range(start, start + size):
            y, state, tail = mamba_seq(cfg, layers[i], h, plan, state0)
            h = plan.act(h + y, "hidden")
            cache["ssm"][i].copy_(state)
            cache["conv"][i].copy_(tail)
        start += size

    cache["ssm"] = plan.act(cache["ssm"], "state")
    for name in ("attn_k", "attn_v"):
        if name in cache:
            cache[name] = plan.act(cache[name], "cache")
    logits = tfm.logits_fn(cfg, params, h[:, -1:, :], plan)[:, 0, :]
    return plan.act(logits, "last_logits"), cache


def decode_step(cfg, params, token, cache, pos: Union[int, torch.Tensor], plan: ShardingPlan):
    """One decode step. **Updates the cache in place**: every layer's state
    and conv tail, and slot ``pos`` of the shared block's K/V of every
    application (indexed by application, not by layer), as the transformer's
    ``decode_step`` updates its cache. Clone a cache that must be reused."""
    B = token.shape[0]
    pos = int(pos)
    x = nn.embedding_apply(params["embed"], token[:, None])[:, 0, :]
    pos_arr = torch.tensor([pos], dtype=torch.int32, device=token.device)
    kv_len = pos_arr + 1  # one device scalar shared by every application's attention
    rope = nn.rope_tables(pos_arr, cfg.resolved_head_dim, cfg.rope_theta)

    layers = nn.unbind_layers(params["layers"])
    start = 0
    for g, size in enumerate(_group_sizes(cfg)):
        if cfg.attn_every:
            lp = params["shared_attn"]
            xs = x[:, None, :]
            xn = tfm._norm(cfg, lp["attn_norm"], xs)
            q, k, v = tfm._qkv(cfg, lp["attn"], xn, plan)
            q = nn.apply_rope(q, pos_arr, cfg.rope_theta, tables=rope)
            k = nn.apply_rope(k, pos_arr, cfg.rope_theta, tables=rope)
            kc, vc = cache["attn_k"][g], cache["attn_v"][g]
            kc[:, pos : pos + 1].copy_(k)
            vc[:, pos : pos + 1].copy_(v)
            out = tfm.decode_attention(q, kc, vc, kv_len=kv_len)
            xs = xs + nn.dense_apply({"w": lp["attn"]["wo"]}, out.reshape(B, 1, -1))
            xs = xs + tfm._mlp(cfg, lp["mlp"], tfm._norm(cfg, lp["mlp_norm"], xs), plan)
            x = xs[:, 0, :]
        for i in range(start, start + size):
            st, tail = cache["ssm"][i], cache["conv"][i]
            y, st2, tail2 = mamba_step(cfg, layers[i], x, st, tail)
            x = x + y
            st.copy_(st2)
            tail.copy_(tail2)
        start += size

    logits = tfm.logits_fn(cfg, params, x[:, None, :], plan)[:, 0, :]
    new_cache = dict(cache, ssm=plan.act(cache["ssm"], "state"))
    for name in ("attn_k", "attn_v"):
        if name in cache:
            new_cache[name] = plan.act(cache[name], "cache")
    return plan.act(logits, "last_logits"), new_cache


def _build_hybrid(cfg: ModelConfig):
    """The ``Model`` facade of the hybrid family (and of ``ssm``, its alias;
    ``model_api`` registers both)."""
    from repro_torch.models.model_api import Model, _input_specs

    def init(gen: torch.Generator, device="cuda"):
        return init_params(cfg, gen, resolve_device(device))

    def loss(params, batch, plan: ShardingPlan):
        logits = forward(cfg, params, batch["tokens"], plan)
        return losses.softmax_cross_entropy(logits, batch["labels"])

    return Model(
        cfg=cfg,
        init=init,
        loss=loss,
        prefill=lambda params, batch, plan: prefill(cfg, params, batch["tokens"], plan),
        decode=lambda params, batch, cache, pos, plan: decode_step(
            cfg, params, batch["token"], cache, pos, plan
        ),
        cache_spec=lambda b, s: cache_spec(cfg, b, s),
        input_specs=lambda suite: _input_specs(cfg, suite),
    )
