"""Encoder-decoder transformer (whisper-base backbone).

The audio frontend is a stub, as in the reference: ``input_specs`` asks for
precomputed frame embeddings of shape (B, n_frames, d_model) standing in for
the two-conv mel frontend; the backbone (encoder self-attention, decoder
self- and cross-attention, gelu MLPs, layernorm, learned decoder positions,
an output head tied to the token embedding) is real. Depth is a Python loop
over the stacked layer parameters.

Every attention goes through ``transformer.flash_attention`` (encoder
non-causal, decoder self causal, cross non-causal with Sq != Skv) and
``transformer.decode_attention`` (decoder self and cross): the flash kernel
(K1) and the decode kernel (K4) on the card. A decode step hands both decode
attentions of every layer their ``kv_len`` as device scalars made by one
host-to-device copy a step.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import losses
from repro_torch.models import module as nn
from repro_torch.models import transformer as tfm
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positions, (length, channels) f32."""
    log_timescale = math.log(10_000.0) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mha(cfg: ModelConfig, init, device, stack) -> Params:
    """Whisper MHA: bias on q/v/o, none on k."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    zeros = functools.partial(torch.zeros, dtype=torch.bfloat16, device=device)
    return {
        "wq": init((*stack, d, cfg.n_heads * hd)),
        "bq": zeros((*stack, cfg.n_heads * hd)),
        "wk": init((*stack, d, cfg.n_kv_heads * hd)),
        "wv": init((*stack, d, cfg.n_kv_heads * hd)),
        "bv": zeros((*stack, cfg.n_kv_heads * hd)),
        "wo": init((*stack, cfg.n_heads * hd, d)),
        "bo": zeros((*stack, d)),
    }


def _init_mlp(cfg: ModelConfig, init, device, stack) -> Params:
    zeros = functools.partial(torch.zeros, dtype=torch.bfloat16, device=device)
    return {
        "w_up": init((*stack, cfg.d_model, cfg.d_ff)),
        "b_up": zeros((*stack, cfg.d_ff)),
        "w_down": init((*stack, cfg.d_ff, cfg.d_model)),
        "b_down": zeros((*stack, cfg.d_model)),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random parameters from a seeded generator, made on ``device``.

    The reference's tree, shapes, types and distributions, layers stacked on
    a leading ``L`` dim; not its bits. ``gen`` must live on ``device``.
    """
    bf16 = torch.bfloat16
    d = cfg.d_model
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    ln = functools.partial(nn.layernorm_init, d, device=device)
    frame_proj = {"w_in": init((d, d))}
    enc = (cfg.enc_layers,)
    enc_layers = {
        "attn_norm": ln(stack=enc),
        "attn": _init_mha(cfg, init, device, enc),
        "mlp_norm": ln(stack=enc),
        "mlp": _init_mlp(cfg, init, device, enc),
    }
    embed = {"table": nn.trunc_normal(gen, (cfg.padded_vocab, d), 1.0 / d**0.5, bf16, device)}
    dec_pos = {"table": nn.trunc_normal(gen, (cfg.max_dec_pos, d), 0.01, bf16, device)}
    dec = (cfg.n_layers,)
    dec_layers = {
        "self_norm": ln(stack=dec),
        "self_attn": _init_mha(cfg, init, device, dec),
        "cross_norm": ln(stack=dec),
        "cross_attn": _init_mha(cfg, init, device, dec),
        "mlp_norm": ln(stack=dec),
        "mlp": _init_mlp(cfg, init, device, dec),
    }
    return {
        # stub frontend projection: frame embeddings -> model space
        "frame_proj": frame_proj,
        "enc_layers": enc_layers,
        "enc_norm": ln(),
        "embed": embed,
        "dec_pos": dec_pos,
        "dec_layers": dec_layers,
        "final_norm": ln(),
        # whisper ties the output head to the token embedding
    }


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _mha_qkv(cfg: ModelConfig, p: Params, xq, xkv, plan: ShardingPlan):
    Bq, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hd = cfg.resolved_head_dim
    q = nn.dense_apply({"w": p["wq"], "b": p["bq"]}, xq)
    k = nn.dense_apply({"w": p["wk"]}, xkv)
    v = nn.dense_apply({"w": p["wv"], "b": p["bv"]}, xkv)
    q = plan.act(q.reshape(Bq, Sq, cfg.n_heads, hd), "heads")
    k = plan.act(k.reshape(Bq, Skv, cfg.n_kv_heads, hd), "kv_heads")
    v = plan.act(v.reshape(Bq, Skv, cfg.n_kv_heads, hd), "kv_heads")
    return q, k, v


def _mha_out(p: Params, out: torch.Tensor, B: int, S: int) -> torch.Tensor:
    return nn.dense_apply({"w": p["wo"], "b": p["bo"]}, out.reshape(B, S, -1))


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = nn.dense_apply({"w": p["w_up"], "b": p["b_up"]}, x)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return nn.dense_apply({"w": p["w_down"], "b": p["b_down"]}, h)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """frames: (B, T, d) stub embeddings -> encoder states (B, T, d)."""
    B, T, _ = frames.shape
    h = nn.dense_apply({"w": params["frame_proj"]["w_in"]}, frames.to(torch.bfloat16))
    h = h + sinusoids(T, cfg.d_model, h.device).to(h.dtype)[None]
    h = plan.act(h, "frames")

    def body(x, lp):
        xn = nn.layernorm_apply(lp["attn_norm"], x)
        q, k, v = _mha_qkv(cfg, lp["attn"], xn, xn, plan)
        out = tfm.flash_attention(q, k, v, causal=False, block_k=cfg.attn_block_k)
        x = x + _mha_out(lp["attn"], out, B, T)
        x = x + _mlp(lp["mlp"], nn.layernorm_apply(lp["mlp_norm"], x))
        return plan.act(x, "frames")

    h = nn.scan_layers(body, h, params["enc_layers"], remat=cfg.remat)
    return nn.layernorm_apply(params["enc_norm"], h)


def _dec_block(cfg, plan, enc_out, B, S, x, lp):
    """One decoder block; returns (x, (k, v, xk, xv)) with the block's self and cross K/V."""
    xn = nn.layernorm_apply(lp["self_norm"], x)
    q, k, v = _mha_qkv(cfg, lp["self_attn"], xn, xn, plan)
    out = tfm.flash_attention(q, k, v, causal=True, block_k=cfg.attn_block_k)
    x = x + _mha_out(lp["self_attn"], out, B, S)
    xn = nn.layernorm_apply(lp["cross_norm"], x)
    qx, xk, xv = _mha_qkv(cfg, lp["cross_attn"], xn, enc_out, plan)
    out = tfm.flash_attention(qx, xk, xv, causal=False, block_k=cfg.attn_block_k)
    x = x + _mha_out(lp["cross_attn"], out, B, S)
    x = x + _mlp(lp["mlp"], nn.layernorm_apply(lp["mlp_norm"], x))
    return plan.act(x, "hidden"), (k, v, xk, xv)


def _dec_embed(cfg, params, tokens, plan, offset: int = 0):
    B, S = tokens.shape
    h = nn.embedding_apply(params["embed"], tokens)
    pos = params["dec_pos"]["table"][offset : offset + S]
    return plan.act(h + pos[None].to(h.dtype), "hidden")


def _logits(cfg, params, h, plan):
    h = nn.layernorm_apply(params["final_norm"], h)
    return tfm.mask_pad_logits(cfg, F.linear(h, params["embed"]["table"].to(torch.bfloat16)))


def forward(cfg: ModelConfig, params: Params, frames, tokens, plan: ShardingPlan):
    """(frames (B, T, d), tokens (B, S)) -> logits (B, S, V)."""
    enc_out = encode(cfg, params, frames, plan)
    B, S = tokens.shape
    h = _dec_embed(cfg, params, tokens, plan)
    h = nn.scan_layers(lambda x, lp: _dec_block(cfg, plan, enc_out, B, S, x, lp)[0], h,
                       params["dec_layers"], remat=cfg.remat)
    return plan.act(_logits(cfg, params, h, plan), "logits")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shape and type of each cache leaf, as ``(shape, dtype)`` pairs: the
    decoder's self-attention K/V (grown by ``pad_cache``) and the cross K/V
    over the encoder's frames (not grown)."""
    hd = cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    cross_shape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, hd)
    bf16 = torch.bfloat16
    return {"k": (self_shape, bf16), "v": (self_shape, bf16), "xk": (cross_shape, bf16), "xv": (cross_shape, bf16)}


def prefill(cfg: ModelConfig, params: Params, frames, tokens, plan: ShardingPlan):
    """Encoder, then the decoder over the prompt, filling the self and cross
    caches. Returns (last-position logits (B, V), cache)."""
    enc_out = encode(cfg, params, frames, plan)
    B, S = tokens.shape
    h = _dec_embed(cfg, params, tokens, plan)
    spec = cache_spec(cfg, B, S)
    spec["xk"] = spec["xv"] = ((cfg.n_layers, *enc_out.shape[:2], cfg.n_kv_heads, cfg.resolved_head_dim),
                               torch.bfloat16)
    cache = {name: torch.empty(shape, dtype=dt, device=h.device) for name, (shape, dt) in spec.items()}
    for i, lp in enumerate(nn.unbind_layers(params["dec_layers"])):
        h, kv = _dec_block(cfg, plan, enc_out, B, S, h, lp)
        for name, t in zip(("k", "v", "xk", "xv"), kv):
            cache[name][i].copy_(t)
    cache = {name: plan.act(t, "cache") for name, t in cache.items()}
    last = _logits(cfg, params, h[:, -1:, :], plan)[:, 0, :]
    return plan.act(last, "last_logits"), cache


def decode_step(cfg, params, token, cache, pos: Union[int, torch.Tensor], plan: ShardingPlan):
    """One decode step. **Updates the self-attention cache in place** (slot
    ``pos`` of every layer), as the transformer's ``decode_step`` does; the
    cross caches are only read."""
    B = token.shape[0]
    pos = int(pos)
    hd = cfg.resolved_head_dim
    h = _dec_embed(cfg, params, token[:, None], plan, offset=pos)
    h = plan.act(h, "decode_hidden")
    # both lengths in one host-to-device copy, each a 1-element view shared by every layer
    lens = torch.tensor([pos + 1, cache["xk"].shape[2]], dtype=torch.int32, device=token.device)
    kv_len, x_len = lens[0:1], lens[1:2]

    for i, lp in enumerate(nn.unbind_layers(params["dec_layers"])):
        kc, vc, xk, xv = cache["k"][i], cache["v"][i], cache["xk"][i], cache["xv"][i]
        xn = nn.layernorm_apply(lp["self_norm"], h)
        q, k, v = _mha_qkv(cfg, lp["self_attn"], xn, xn, plan)
        kc[:, pos : pos + 1].copy_(k)
        vc[:, pos : pos + 1].copy_(v)
        out = tfm.decode_attention(q, kc, vc, kv_len=kv_len)
        h = h + _mha_out(lp["self_attn"], out, B, 1)
        xn = nn.layernorm_apply(lp["cross_norm"], h)
        qx = nn.dense_apply({"w": lp["cross_attn"]["wq"], "b": lp["cross_attn"]["bq"]}, xn)
        out = tfm.decode_attention(qx.reshape(B, 1, cfg.n_heads, hd), xk, xv, kv_len=x_len)
        h = h + _mha_out(lp["cross_attn"], out, B, 1)
        h = h + _mlp(lp["mlp"], nn.layernorm_apply(lp["mlp_norm"], h))
        h = plan.act(h, "decode_hidden")

    logits = _logits(cfg, params, h, plan)[:, 0, :]
    new_cache = dict(cache, k=plan.act(cache["k"], "cache"), v=plan.act(cache["v"], "cache"))
    return plan.act(logits, "last_logits"), new_cache


def _build_encdec(cfg: ModelConfig):
    """The ``Model`` facade of the encdec family (``model_api`` registers it)."""
    from repro_torch.models.model_api import Model, _input_specs

    def init(gen: torch.Generator, device="cuda"):
        return init_params(cfg, gen, resolve_device(device))

    def loss(params, batch, plan: ShardingPlan):
        logits = forward(cfg, params, batch["frames"], batch["tokens"], plan)
        return losses.softmax_cross_entropy(logits, batch["labels"])

    return Model(
        cfg=cfg,
        init=init,
        loss=loss,
        prefill=lambda params, batch, plan: prefill(cfg, params, batch["frames"], batch["tokens"], plan),
        decode=lambda params, batch, cache, pos, plan: decode_step(
            cfg, params, batch["token"], cache, pos, plan
        ),
        cache_spec=lambda b, s: cache_spec(cfg, b, s),
        input_specs=lambda suite: _input_specs(cfg, suite),
    )
