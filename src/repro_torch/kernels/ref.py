"""Plain PyTorch versions of the CUDA kernels in this package.

These are what the kernels are held against on the card and what the
wrappers run for a tensor that lies on the CPU. They are deliberately
naive — O(S^2) attention materializing the score matrix in f32 — because
clarity is the point of an oracle.
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


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D) single query token
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention against a (masked) KV cache."""
    B, H, D = q.shape
    _, Smax, KVH, _ = k_cache.shape
    G = H // KVH
    scale = D**-0.5 if scale is None else scale
    qf = q.reshape(B, KVH, G, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.reshape(())
    s = torch.where(pos[None, None, None, :] < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)
