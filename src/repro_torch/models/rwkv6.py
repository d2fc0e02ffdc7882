"""RWKV-6 "Finch" (rwkv6-1.6b): attention-free LM with data-dependent decay.

The chunked WKV scan: within a chunk the recurrence is expanded into a
bounded pairwise form (all exponents are differences of cumulative
log-decays, hence <= 0 and overflow-safe), and the state is carried from
chunk to chunk. Decode carries the (B, H, K, V) wkv state plus the
token-shift hiddens, so serving cost is sequence-length independent.

Math (per head, state S in R^{KxV}, decay w_t in (0,1)^K, bonus u in R^K):
  o_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
  S_t = diag(w_t) S_{t-1} + k_t v_t^T

Prefill sends a CUDA tensor to the WKV6 kernel (``ops.wkv6``) and a CPU
tensor to ``wkv_chunked``, where the reference sends a TPU array to its
Pallas kernel and anything else to ``wkv_chunked``. ``forward`` on the CPU is
differentiable; the kernel has no backward, here as in the reference.

Under a mesh (DTensors) the scan, the kernel or ``wkv_chunked``, and the
decode step's ``wkv_step`` run on each rank's batch rows and heads
(``ops.wkv6_on_shards``), the plan's ``"heads"`` layout with the sequence
whole; the states come back in the ``"state"`` layout.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import wkv6, wkv6_on_shards
from repro_torch.models import losses
from repro_torch.models import module as nn
from repro_torch.models import transformer as tfm
from repro_torch.sharding import dist
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# chunked WKV core (the model's CPU path; the CUDA kernel computes the same)
# ---------------------------------------------------------------------------


def wkv_chunked(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K), log-decay, <= 0
    u: torch.Tensor,  # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,T,H,V) f32, final state (B,H,K,V) f32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    assert T % chunk == 0, f"T={T} must be divisible by chunk={chunk}"
    n = T // chunk

    def chunks(x, width):  # (B, T, H, X) -> (n, B, H, C, X)
        return x.float().reshape(B, n, chunk, H, width).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = chunks(r, K), chunks(k, K), chunks(v, V), chunks(logw, K)
    uf = u.float()
    tri_strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)

    S = state0.float()
    outs = []
    for rb, kb, vb, wb in zip(rc, kc, vc, wc):  # (B,H,C,K/V)
        clw = torch.cumsum(wb, dim=2)  # inclusive cumulative log-decay
        clw_ex = clw - wb  # exclusive
        # pairwise decay exponent for s < t: clw_ex[t] - clw[s] <= 0
        diff = clw_ex[:, :, :, None, :] - clw[:, :, None, :, :]  # (B,H,C,C,K)
        decay = torch.exp(torch.where(tri_strict[None, None, :, :, None], diff, -torch.inf))
        scores = torch.einsum("bhtk,bhsk,bhtsk->bhts", rb, kb, decay)
        # diagonal bonus term: r_t . (u * k_t)
        diag = torch.einsum("bhtk,hk->bht", rb * kb, uf)
        out = torch.einsum("bhts,bhsv->bhtv", scores, vb)
        out = out + diag[..., None] * vb
        # cross-chunk: r_t decayed to chunk start @ S
        out = out + torch.einsum("bhtk,bhkv->bhtv", rb * torch.exp(clw_ex), S)
        # state update: S' = exp(clw[-1]) * S + sum_s exp(clw[-1]-clw[s]) k_s v_s^T
        last = clw[:, :, -1:, :]  # (B,H,1,K)
        kdec = kb * torch.exp(last - clw)
        S = torch.exp(last[:, :, 0, :])[..., None] * S + torch.einsum("bhsk,bhsv->bhkv", kdec, vb)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return out, S


def wkv_step(r, k, v, logw, u, state):
    """Single-token recurrence. r/k/logw: (B,H,K); v: (B,H,V); state (B,H,K,V)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]  # (B,H,K,V)
    out = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    return out, state


def _wkv_step_on_shards(r, k, v, logw, u, state):
    """``wkv_step``; on DTensors, on each rank's batch rows and heads, the
    state's layout, as ``ops.wkv6_on_shards`` runs the scan."""
    same = {0: 0, 1: 1}
    return dist.on_shards(wkv_step, r, [(r, same), (k, same), (v, same), (logw, same), (u, {1: 0}), (state, same)],
                          [same, same], head_dim=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _lora_init(init, L: int, d: int, rank: int, out: int, device) -> Params:
    return {
        "a": init((L, d, rank)),
        "b": nn.zeros_init(None, (L, rank, out), torch.bfloat16, device),
    }


def _lora(p: Params, x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """The decay's low-rank map, its output on each rank's heads (``ShardingPlan.cols``)."""
    h = torch.tanh(torch.matmul(x, p["a"].to(x.dtype)))
    return torch.matmul(h, plan.cols(p["b"]).to(x.dtype))


def init_time_mix(cfg: ModelConfig, init, device) -> Params:
    L, d, s = cfg.n_layers, cfg.d_model, cfg.ssm
    H = d // s.head_dim
    return {
        "mu": torch.full((L, 5, d), 0.5, dtype=torch.bfloat16, device=device),  # r,k,v,w,g lerps
        "w_r": init((L, d, d)),
        "w_k": init((L, d, d)),
        "w_v": init((L, d, d)),
        "w_g": init((L, d, d)),
        "w_out": init((L, d, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5),
        "decay_base": torch.full((L, d), -6.0, dtype=torch.float32, device=device),  # strong decay
        "decay_lora": _lora_init(init, L, d, s.lora_rank, d, device),
        "bonus_u": torch.full((L, H, s.head_dim), 0.5, dtype=torch.float32, device=device),
        "ln_out": nn.layernorm_init(d, device=device, stack=(L,)),
    }


def init_channel_mix(cfg: ModelConfig, init, device) -> Params:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full((L, 2, d), 0.5, dtype=torch.bfloat16, device=device),  # k, r lerps
        "w_in": init((L, d, f)),
        "w_r": init((L, d, d)),
        "w_out": init((L, f, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random parameters from a seeded generator, made on ``device``.

    The reference's tree, shapes, types and distributions, layers stacked on
    a leading ``L`` dim; not its bits. ``gen`` must live on ``device``.
    """
    bf16 = torch.bfloat16
    L, d = cfg.n_layers, cfg.d_model
    init = functools.partial(nn.fan_in_init, gen, dtype=bf16, device=device)
    return {
        "embed": {
            "table": nn.trunc_normal(gen, (cfg.padded_vocab, d), 1.0 / d**0.5, bf16, device)
        },
        "embed_norm": nn.layernorm_init(d, device=device),
        "layers": {
            "tm_norm": nn.layernorm_init(d, device=device, stack=(L,)),
            "time_mix": init_time_mix(cfg, init, device),
            "cm_norm": nn.layernorm_init(d, device=device, stack=(L,)),
            "channel_mix": init_channel_mix(cfg, init, device),
        },
        "final_norm": nn.layernorm_init(d, device=device),
        "lm_head": {"w_lm": init((d, cfg.padded_vocab))},
    }


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}; for t=0 uses ``prev`` (decode carry) or zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _decay(p: Params, xw: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """Data-dependent decay (Finch): logw = -exp(w0 + lora(xw)), in (-inf, 0), f32."""
    return -torch.exp(p["decay_base"].float() + _lora(p["decay_lora"], xw, plan).float())


def _head_proj(plan: ShardingPlan, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on the columns of each rank's heads (``ShardingPlan.cols``):
    the time mix's r, k, v and g, whose heads the plan splits over ``model``."""
    return nn.dense_apply({"w": plan.cols(w)}, x)


def time_mix_seq(
    cfg: ModelConfig, p: Params, x: torch.Tensor, plan: ShardingPlan,
    state0: torch.Tensor, x_prev: Optional[torch.Tensor] = None,
):
    """Sequence-mode time mixing. x: (B,T,d). Returns (y, new_state, last_x).

    A CUDA tensor goes to the WKV6 kernel (at any T: it masks a short last
    chunk), a CPU tensor to ``wkv_chunked``.
    """
    B, T, d = x.shape
    s = cfg.ssm
    H, K = d // s.head_dim, s.head_dim
    # under sp the sequence is whole before the shift, which reads each
    # position's predecessor: the five projections below would gather it
    # anyway (``dist.rows_flattenable``), so one gather here serves them all
    x = dist.whole_on(x, 1)
    xp = _token_shift(x, x_prev)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xp, mu[i]) for i in range(5))
    r, k, v = (dist.split_heads(_head_proj(plan, p[w], xi), H, K)
               for w, xi in (("w_r", xr), ("w_k", xk), ("w_v", xv)))
    g = _head_proj(plan, p["w_g"], xg)
    logw = dist.split_heads(_decay(p, xw, plan), H, K)
    # the scan's layout: batch over the data axes, heads over ``model``, the
    # sequence whole on every rank
    r, k, v, logw = (plan.act(t, "heads") for t in (r, k, v, logw))
    scan = wkv6 if x.device.type == "cuda" else functools.partial(wkv6_on_shards, wkv_chunked)
    out, state = scan(r, k, v, logw, p["bonus_u"], state0, chunk=s.chunk)
    out = plan.act(out.to(torch.bfloat16), "heads")
    out = nn.layernorm_apply(p["ln_out"], out.reshape(B, T, d))  # group-norm-ish
    out = out * F.silu(g.float()).to(out.dtype)
    y = nn.dense_apply({"w": p["w_out"]}, out)
    return y, state, x[:, -1, :]


def _channel_mix(p: Params, xk: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    h = nn.dense_apply({"w": p["w_in"]}, xk)
    h = torch.square(F.relu(h.float())).to(h.dtype)
    r = torch.sigmoid(nn.dense_apply({"w": p["w_r"]}, xr).float()).to(h.dtype)
    return r * nn.dense_apply({"w": p["w_out"]}, h)


def channel_mix_seq(
    cfg: ModelConfig, p: Params, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
):
    x = dist.whole_on(x, 1)  # under sp, as ``time_mix_seq`` does
    xp = _token_shift(x, x_prev)
    y = _channel_mix(p, _lerp(x, xp, p["mu"][0]), _lerp(x, xp, p["mu"][1]))
    return y, x[:, -1, :]


def block_seq(cfg: ModelConfig, plan: ShardingPlan, x, lp: Params, state0):
    y, state, tm_last = time_mix_seq(
        cfg, lp["time_mix"], nn.layernorm_apply(lp["tm_norm"], x), plan, state0
    )
    x = plan.act(x + y, "hidden")
    y, cm_last = channel_mix_seq(
        cfg, lp["channel_mix"], nn.layernorm_apply(lp["cm_norm"], x)
    )
    x = plan.act(x + y, "hidden")
    return x, state, (tm_last, cm_last)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return nn.layernorm_apply(params["embed_norm"], nn.embedding_apply(params["embed"], tokens))


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = nn.layernorm_apply(params["final_norm"], h)
    return tfm.mask_pad_logits(cfg, nn.dense_apply({"w": params["lm_head"]["w_lm"]}, h))


def _zero_state(cfg: ModelConfig, B: int, device) -> torch.Tensor:
    K = cfg.ssm.head_dim
    return torch.zeros((B, cfg.d_model // K, K, K), dtype=torch.float32, device=device)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Token ids (B, T) -> logits (B, T, V)."""
    h = plan.act(_embed(params, tokens), "hidden")
    state0 = _zero_state(cfg, tokens.shape[0], h.device)

    def body(x, lp):
        return block_seq(cfg, plan, x, lp, state0)[0]

    h = nn.scan_layers(body, h, params["layers"], remat=cfg.remat)
    return plan.act(_logits(cfg, params, h), "logits")


# ---------------------------------------------------------------------------
# serving: state cache = {wkv (L,B,H,K,V), tm_x (L,B,d), cm_x (L,B,d)}
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, _max_len: int):
    """Shape and type of each cache leaf, as ``(shape, dtype)`` pairs."""
    K = cfg.ssm.head_dim
    L, d = cfg.n_layers, cfg.d_model
    return {
        "wkv": ((L, batch, d // K, K, K), torch.float32),
        "tm_x": ((L, batch, d), torch.bfloat16),
        "cm_x": ((L, batch, d), torch.bfloat16),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, plan: ShardingPlan):
    """Full-sequence forward that also returns the state cache.

    Returns (last-position logits (B, V), cache).
    """
    h = plan.act(_embed(params, tokens), "hidden")
    state0 = _zero_state(cfg, tokens.shape[0], h.device)
    states, tm_xs, cm_xs = [], [], []
    for lp in nn.unbind_layers(params["layers"]):
        h, state, (tm_last, cm_last) = block_seq(cfg, plan, h, lp, state0)
        states.append(state)
        tm_xs.append(tm_last.to(torch.bfloat16))
        cm_xs.append(cm_last.to(torch.bfloat16))
    logits = _logits(cfg, params, h[:, -1:, :])[:, 0, :]
    cache = {
        "wkv": plan.act(torch.stack(states), "state"),
        "tm_x": torch.stack(tm_xs),
        "cm_x": torch.stack(cm_xs),
    }
    return plan.act(logits, "last_logits"), cache


def decode_step(cfg, params, token, cache, _pos, plan: ShardingPlan):
    """One decode step against the state cache.

    **Updates the cache in place**, as the transformer's ``decode_step``
    does: layer ``i`` of ``wkv``, ``tm_x`` and ``cm_x`` is overwritten and
    the same dict's tensors are returned (the reference returns fresh
    arrays). Clone a cache that must be reused.
    """
    B = token.shape[0]
    d = cfg.d_model
    H, K = d // cfg.ssm.head_dim, cfg.ssm.head_dim
    # the stream in the layout each layer leaves it in (at batch 1 d over
    # ``data``), so that layer 0's products contract over d's shards as the
    # later layers' do
    x = plan.decode_stream(_embed(params, token[:, None])[:, 0, :])  # (B, d)

    for i, lp in enumerate(nn.unbind_layers(params["layers"])):
        wkv, tm_x, cm_x = cache["wkv"][i], cache["tm_x"][i], cache["cm_x"][i]
        tm = lp["time_mix"]
        xn_tm = nn.layernorm_apply(lp["tm_norm"], x)
        mu = tm["mu"]
        xr, xk, xv, xw, xg = (_lerp(xn_tm, tm_x.to(xn_tm.dtype), mu[j]) for j in range(5))
        r, k, v = (dist.split_heads(_head_proj(plan, tm[w], xi), H, K)
                   for w, xi in (("w_r", xr), ("w_k", xk), ("w_v", xv)))
        g = _head_proj(plan, tm["w_g"], xg)
        logw = dist.split_heads(_decay(tm, xw, plan), H, K)
        out, wkv_new = _wkv_step_on_shards(r, k, v, logw, tm["bonus_u"], wkv)
        out = nn.layernorm_apply(tm["ln_out"], out.to(torch.bfloat16).reshape(B, d))
        out = out * F.silu(g.float()).to(out.dtype)
        # each row-parallel product's partial sums reduced before they join the
        # stream (its shards kept: at batch 1 the data axes shard d)
        x = x + dist.reduced(nn.dense_apply({"w": tm["w_out"]}, out))
        # channel mix
        # its receptance product as the plan lays a decode product (at batch
        # 1 on each rank's columns: whole on ``model`` it is half the step's
        # FLOPs a device)
        cm = dict(lp["channel_mix"], w_r=plan.decode_cols(lp["channel_mix"]["w_r"]))
        xn_cm = nn.layernorm_apply(lp["cm_norm"], x)
        x_cm = cm_x.to(xn_cm.dtype)
        x = x + dist.reduced(_channel_mix(cm, _lerp(xn_cm, x_cm, cm["mu"][0]), _lerp(xn_cm, x_cm, cm["mu"][1])))
        # carries: the *inputs* each mixer saw this step (token-shift sources)
        dist.write(wkv, wkv_new)
        dist.write(tm_x, xn_tm)
        dist.write(cm_x, xn_cm)

    logits = _logits(cfg, params, x)
    cache = {"wkv": plan.act(cache["wkv"], "state"), "tm_x": cache["tm_x"], "cm_x": cache["cm_x"]}
    return plan.act(logits, "last_logits"), cache


def _build_rwkv(cfg: ModelConfig):
    """The ``Model`` facade of the rwkv family (``model_api`` registers it)."""
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
