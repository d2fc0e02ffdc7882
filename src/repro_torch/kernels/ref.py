"""Plain PyTorch versions of the CUDA kernels in this package.

These are what the kernels are held against on the card and what the
wrappers run for a tensor that lies on the CPU. They are deliberately
naive — O(S^2) attention materializing the score matrix in f32, the WKV6
recurrence token by token — because clarity is the point of an oracle.
``flash_attention_bwd_reference`` is the plain version of both backward
kernels: it recomputes ``p`` from the saved ``lse`` as they do, rather than
differentiating ``mha_reference``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive GQA attention: full (Sq, Skv) score matrix, f32 softmax."""
    return mha_reference_with_lse(
        q, k, v, causal=causal, q_offset=q_offset, scale=scale
    )[0]


def mha_reference_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mha_reference`` plus the row log-sum-exp, (B, Sq, H) f32.

    A fully masked row gives the flash kernel's numbers, not NaN: the mask
    value is the finite ``NEG_INF``, so its softmax is uniform over the row.
    """
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = D**-0.5 if scale is None else scale
    qf = q.reshape(B, Sq, KVH, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)  # (B,Sq,KVH,G)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype), lse.reshape(B, Sq, H)


def flash_attention_bwd_reference(
    q: torch.Tensor,  # (B, KVH, Sq, G, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,  # (B, KVH, Skv, D)
    o: torch.Tensor,  # (B, KVH, Sq, G, D)
    lse: torch.Tensor,  # (B, KVH, Sq, G) f32
    do: torch.Tensor,  # (B, KVH, Sq, G, D)
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention in the folded layout, all in f32 inside.

    ``p = exp(scale * q.k^T - lse)`` is recomputed from the forward's ``lse``,
    ``delta = sum_d o * do``, ``ds = p * (do.v^T - delta)``; then
    ``dv = p^T.do``, ``dk = scale * ds^T.q`` and ``dq = scale * ds.k``, the
    sums over the G folded rows landing on their shared KV head. Outputs come
    back in the types of q, k and v.
    """
    Sq, Skv = q.shape[2], k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqgd,bhkd->bhqgk", qf, kf) * scale
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    delta = (o.float() * dof).sum(dim=-1)
    dv = torch.einsum("bhqgk,bhqgd->bhkd", p, dof)
    dp = torch.einsum("bhqgd,bhkd->bhqgk", dof, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqgk,bhqgd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqgk,bhkd->bhqgd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D) single query token
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Single-token decode attention against a (masked) KV cache.

    With ``return_lse`` flash-decode's partial, as the decode kernel returns
    it: o in f32 and the log-sum-exp of the scaled scores over the valid
    rows, (B, H) f32; where no row is valid, lse = −inf and o = 0 (a shard of
    the cache past ``kv_len``). Without it, o is the reference's
    ``decode_attention_reference``'s, whose masked row is uniform instead.
    """
    B, H, D = q.shape
    _, Smax, KVH, _ = k_cache.shape
    G = H // KVH
    scale = D**-0.5 if scale is None else scale
    qf = q.reshape(B, KVH, G, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.reshape(())
    valid = pos[None, None, None, :] < kv_len
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    if not return_lse:
        return o.reshape(B, H, D).to(q.dtype)
    lse = torch.logsumexp(torch.where(valid, s, float("-inf")), dim=-1)  # -inf where no row is valid
    o = torch.where(torch.isfinite(lse)[..., None], o, 0.0)
    return o.reshape(B, H, D), lse.reshape(B, H)


def wkv6_reference(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K) log-decay <= 0
    u: torch.Tensor,  # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token WKV6 recurrence (RWKV-6 'Finch'):

        o_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
        S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

    Returns (out (B,T,H,V) f32, final state (B,H,K,V) f32); given float64
    inputs it computes and returns float64.
    """
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf = (x.to(dt) for x in (r, k, v, logw))
    uf = u.to(dt)
    S = state0.to(dt)
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf[None, :, :, None] * kv))
        S = torch.exp(wf[:, t])[..., None] * S + kv
    out = torch.stack(outs, dim=1) if outs else vf.new_zeros(vf.shape)
    return out, S
