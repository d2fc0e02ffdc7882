"""Attention implementations.

``xla_flash_attention`` keeps the name of its counterpart in the reference:
a blocked online-softmax attention over KV blocks in plain PyTorch, so the
S x S score matrix is never materialized. It is the path of CPU tensors and
of the calls the flash kernel does not cover (a dynamic ``kv_len``).
The CUDA kernels in ``repro_torch.kernels`` are the hot path on the card.

Dispatch is decided from the arguments alone (device, ``kv_len``) before
anything is launched, never from an exception or from process state: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30

def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_k: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
    kv_len: Optional[Union[torch.Tensor, int]] = None,
) -> torch.Tensor:
    """Device dispatch: the CUDA kernel on the card, the blocked path elsewhere.

    A CUDA tensor goes to the flash kernel when ``kv_len is None``, at any
    sequence length and ``q_offset`` (the kernel masks its ragged edge).
    Every other call, and every CPU tensor, runs ``xla_flash_attention``.
    """
    if q.device.type == "cuda" and kv_len is None:
        return ops.flash_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    return xla_flash_attention(
        q, k, v, causal=causal, block_k=block_k, q_offset=q_offset,
        scale=scale, kv_len=kv_len,
    )


def xla_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_k: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
    kv_len: Optional[Union[torch.Tensor, int]] = None,
) -> torch.Tensor:
    """Blocked GQA attention with online softmax, plain PyTorch.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D). H = KVH * G.
    ``q_offset``: absolute position of q[0] (prefill=0; decode=cache length).
    ``kv_len``: optional dynamic valid-KV length (decode with ring cache).
    Returns (B, Sq, H, D) in q.dtype.

    As in the reference, q*scale is rounded to the K/V storage type and the
    dots accumulate in f32; p stays f32 for the value product.
    """
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale if scale is not None else D**-0.5
    dev = q.device

    qf = (q.reshape(B, Sq, KVH, G, D).float() * scale).to(k.dtype).float()
    block_k = min(block_k, Skv)
    n_blocks = -(-Skv // block_k)
    q_pos = q_offset + torch.arange(Sq, device=dev)  # (Sq,)

    acc = torch.zeros((B, Sq, KVH, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KVH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=dev)
    for idx in range(n_blocks):
        lo = idx * block_k
        hi = min(lo + block_k, Skv)  # a short last block stands for the reference's zero padding + mask
        kblk = k[:, lo:hi].float()
        vblk = v[:, lo:hi].float()
        kv_pos = torch.arange(lo, hi, device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kblk)
        mask = torch.ones((Sq, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if kv_len is not None:
            mask &= kv_pos[None, :] < kv_len
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vblk)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention.

    q: (B, 1, H, D); caches: (B, Smax, KVH, D). ``kv_len``: number of valid
    cache entries (an int, or a 1-element int32 tensor on q's device).

    A CUDA tensor goes to the decode kernel through ``ops.decode_attention``,
    as ``flash_attention`` sends one to the flash kernel. A CPU tensor runs
    the masked softmax below, which rounds q*scale and p to the cache's type
    before the dots as the reference's decode path does.
    """
    if q.device.type == "cuda":
        return ops.decode_attention(q, k_cache, v_cache, kv_len=kv_len, scale=scale)
    return torch_decode_attention(q, k_cache, v_cache, kv_len=kv_len, scale=scale)


def torch_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The non-kernel decode attention: full masked softmax over the cache."""
    B, _, H, D = q.shape
    _, Smax, KVH, _ = k_cache.shape
    G = H // KVH
    scale = scale if scale is not None else D**-0.5
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.reshape(())
    qf = (q.reshape(B, KVH, G, D).float() * scale).to(k_cache.dtype).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())  # (B,KVH,G,Smax) f32
    pos = torch.arange(Smax, device=q.device)
    s = torch.where(pos[None, None, None, :] < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
