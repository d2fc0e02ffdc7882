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

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import module as nn
from repro_torch.sharding import dist

NEG_INF = -1e30


class Heads(NamedTuple):
    """What an attention reads (``heads``): q (B, Sq, H, D), k and v (B, Skv,
    KVH, D), RoPE'd where the model rotates them."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    causal: bool


def heads(plan, q, k, v, n_heads: int, n_kv_heads: int, head_dim: int, *, causal: bool = True,
          theta: Optional[float] = None, positions: Optional[torch.Tensor] = None,
          tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Union[Heads, "ops.RowShareInputs"]:
    """The projections' outputs q (B, Sq, H·D), k and v (B, Skv, KVH·D) as
    the attention reads them, RoPE'd where ``theta`` is given: at
    ``positions`` (default rows 0..Sq-1) or from ``tables``, their
    ``rope_tables``. ``attend`` runs the attention on it, and prefill's
    ``write_cache`` stores its K/V.

    Where ``model`` does not divide the query heads of a DTensor
    (``dist.row_split``) and the rows hold a part each, the rank's row share
    (``ops.row_share_inputs``): q's share and the KV heads it reads come from
    the projections' column blocks by all-to-alls inside its group, nothing
    gathered whole, and RoPE runs on the share, q at its own rows, k on all
    rows, with the whole sequence's tables: the bits of RoPE on the whole
    tensor, sliced; columns that ``model`` does not divide raise
    (``RowShareExchange``, ``KvToShare``). Everywhere else ``Heads``: the heads viewed
    (``dist.split_heads``) in the plan's ``heads`` and ``kv_heads`` specs,
    then RoPE."""
    tp = dist.tp_size(q.device_mesh) if dist.is_dtensor(q) else 1
    parts = dist.share_of(0, n_heads, n_kv_heads, tp).parts if tp > 1 else 1
    if parts > 1 and q.shape[1] >= parts:
        ins = ops.row_share_inputs(q, k, v, dist.row_split(q.device_mesh, n_heads, n_kv_heads), n_kv_heads,
                                   head_dim, causal)
        if theta is None:
            return ins
        if tables is None:
            positions = torch.arange(q.shape[1], device=q.device) if positions is None else positions
            tables = nn.rope_tables(positions, head_dim, theta)
        q_share, k_share = rope_on_share(ins.q, ins.k, ins.rows, tables)
        return dataclasses.replace(ins, q=q_share, k=k_share)
    q = plan.act(dist.split_heads(q, n_heads, head_dim), "heads")
    k = plan.act(dist.split_heads(k, n_kv_heads, head_dim), "kv_heads")
    v = plan.act(dist.split_heads(v, n_kv_heads, head_dim), "kv_heads")
    if theta is not None:
        positions = torch.arange(q.shape[1], device=q.device) if positions is None else positions
        q = nn.apply_rope(q, positions, theta, tables=tables)
        k = nn.apply_rope(k, positions, theta, tables=tables)
    return Heads(q, k, v, causal)


def rope_on_share(q: torch.Tensor, k: torch.Tensor, rows: Tuple[slice, ...],
                  tables: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on a row share's local operands: ``q`` (B, R, Hg, D) on the rows
    ``rows`` (in order) at their own positions, ``k`` (B, Skv, n, D) on
    every row, from ``tables`` (``rope_tables``) of the whole sequence. RoPE
    is elementwise in f32 and rounded once, so these are the bits of RoPE on
    the whole tensors, sliced."""
    at_rows = tuple(torch.cat([t[r] for r in rows]) for t in tables)
    return nn.apply_rope(q, None, tables=at_rows), nn.apply_rope(k, None, tables=tables)


def attend(h: Union[Heads, "ops.RowShareInputs"], *, block_k: int = 1024) -> torch.Tensor:
    """The attention on ``heads``' output: (B, Sq, H·D), ``wo``'s input."""
    if isinstance(h, ops.RowShareInputs):
        return ops.flash_on_row_share(h)
    return flash_attention(h.q, h.k, h.v, causal=h.causal, block_k=block_k)


def write_cache(h: Union[Heads, "ops.RowShareInputs"], k_cache: torch.Tensor, v_cache: torch.Tensor,
                layer: int) -> None:
    """Prefill's write of ``heads``' K/V into rows 0.. of layer ``layer`` of
    the caches (L, B, S, KVH, D), each rank into its own shard: from a row
    share by an exchange of the ranks' column blocks
    (``ops.write_row_share_cache``), else ``dist.write_rows``."""
    if isinstance(h, ops.RowShareInputs):
        ops.write_row_share_cache(h, k_cache[layer], v_cache[layer])
        return
    dist.write_rows(k_cache[layer], 1, 0, h.k)
    dist.write_rows(v_cache[layer], 1, 0, h.v)


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
    sequence length and ``q_offset`` (the kernel masks its ragged edge), and
    so does a DTensor (``ops`` runs the kernel, or for CPU shards its plain
    version, on the local shards). Every other call, and every plain CPU
    tensor, runs ``xla_flash_attention``. The output is (B, Sq, H·D), the
    input of ``wo``, as a row share's output (``attend``).
    """
    if kv_len is None and (q.device.type == "cuda" or dist.is_dtensor(q)):
        B, S, H, D = q.shape
        return ops.flash_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset).reshape(B, S, H * D)
    out = xla_flash_attention(
        q, k, v, causal=causal, block_k=block_k, q_offset=q_offset,
        scale=scale, kv_len=kv_len,
    )
    return out.flatten(2)


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
    as ``flash_attention`` sends one to the flash kernel, and so does a
    DTensor. A plain CPU tensor runs the masked softmax below, which rounds
    q*scale and p to the cache's type before the dots as the reference's
    decode path does.
    """
    if q.device.type == "cuda" or dist.is_dtensor(q):
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
