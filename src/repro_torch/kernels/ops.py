"""Public wrappers around the CUDA kernels with the model-API layout.

The model API uses (B, S, H, D); the flash kernel uses the GQA-folded
(B, KVH, S, G, D). The folds are views: the kernel addresses its tensors
through strides, so no copy is made on the way in or out.

There is no execution-mode switch: a tensor on the card goes to the kernel
(or the call raises), a tensor on the CPU goes to the kernel's plain version
in ``ref.py``. ``flash_attention`` is differentiable: a
``torch.autograd.Function`` runs the forward kernel and, in backward, the dq
and dk/dv kernels, the twin of the reference's ``_flash`` under
``custom_vjp``. The decode and WKV6 kernels have no backward, here as in
the reference.

Each wrapper also takes DTensors (the sharded steps of ``runtime/``): it
redistributes them to a layout in which the kernel's work is local -- the
batch over the data axes, heads over ``model`` (``sharding.dist.
kernel_placements``); a sequence-sharded input is gathered on the sequence
there, as GSPMD would gather it -- runs the same kernel (or, for a CPU
tensor, its plain version) on the local shards, and wraps the result back.
Both ends are differentiable, so ``_Flash`` runs unchanged under them.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.sharding import dist


def _fold(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, KVH, S, G, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, kvh, H // kvh, D).permute(0, 2, 1, 3, 4)


def _unfold(qf: torch.Tensor) -> torch.Tensor:
    """(B, KVH, S, G, D) -> (B, S, H, D)."""
    B, KVH, S, G, D = qf.shape
    return qf.permute(0, 2, 1, 3, 4).reshape(B, S, KVH * G, D)


def _kv_fold(k: torch.Tensor) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, KVH, S, D)."""
    return k.permute(0, 2, 1, 3)


class _Flash(torch.autograd.Function):
    """Saves (q, k, v, o, lse) in the model layout; both directions fold them.

    Unlike the reference's ``_flash_bwd``, which drops it, ``q_offset`` goes
    to the backward as well as to the forward.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_offset: int):
        kvh = k.shape[2]
        o, lse = fa.flash_attention_fwd(
            _fold(q, kvh), _kv_fold(k), _kv_fold(v),
            causal=causal, scale=scale, q_offset=q_offset,
        )
        o = _unfold(o)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kvh = k.shape[2]
        dq, dk, dv = fa.flash_attention_bwd(
            _fold(q, kvh), _kv_fold(k), _kv_fold(v), _fold(o, kvh), lse,
            _fold(do.contiguous(), kvh),
            causal=ctx.causal, scale=ctx.scale, q_offset=ctx.q_offset,
        )
        return _unfold(dq), _kv_fold(dk), _kv_fold(dv), None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA flash attention with the model-API layout. Differentiable."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    if dist.is_dtensor(q):
        mesh = q.device_mesh
        pl = dist.kernel_placements(mesh, q.shape[0], (q.shape[2], k.shape[2]), 0, 2)
        ql, kl, vl = (dist.to_local_as(x, mesh, pl) for x in (q, k, v))
        return dist.from_local(_Flash.apply(ql, kl, vl, causal, scale, q_offset), mesh, pl)
    return _Flash.apply(q, k, v, causal, scale, q_offset)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) or (B, H, D)
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention; returns q-shaped output."""
    if dist.is_dtensor(q):
        mesh = q.device_mesh
        heads = (q.shape[-2], k_cache.shape[2])
        pl_q = dist.kernel_placements(mesh, q.shape[0], heads, 0, q.dim() - 2)
        pl_c = dist.kernel_placements(mesh, q.shape[0], heads, 0, 2)
        out = decode_attention(dist.to_local_as(q, mesh, pl_q), dist.to_local_as(k_cache, mesh, pl_c),
                               dist.to_local_as(v_cache, mesh, pl_c), kv_len=dist.full(kv_len), scale=scale)
        return dist.from_local(out, mesh, pl_q)
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    out = da.decode_attention(q3, k_cache, v_cache, kv_len, scale=scale)
    return out[:, None] if squeeze else out


def wkv6(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K) log-decay <= 0
    u: torch.Tensor,  # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 scan; returns (out (B,T,H,V) f32, state (B,H,K,V) f32).

    A CUDA tensor goes to the kernel, a CPU tensor to ``ref.wkv6_reference``
    (the reference's ``mode="ref"``). The kernel has no backward, as the
    reference's ``wkv6`` has no ``custom_vjp``: on the card a call that
    autograd would have to differentiate raises (in ``rk.wkv6_scan``) rather
    than computing the gradient some other way.
    """
    return wkv6_on_shards(rk.wkv6_scan, r, k, v, logw, u, state0, chunk=chunk)


def wkv6_on_shards(scan, r, k, v, logw, u, state0, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan(r, k, v, logw, u, state0, **kw)`` (the kernel, or a plain
    version of it); on DTensors, on each rank's batch rows and heads with the
    sequence whole (``dist.on_shards``), ``out`` back in that layout and the
    state batch over the data axes and heads over ``model``. The bonus ``u``
    takes the same heads, its gradient (a plain version's) summed over the
    ranks that split the batch."""
    whole, state = {0: 0, 1: 1, 2: 2, 3: 3}, {0: 0, 2: 1}
    return dist.on_shards(lambda *a: scan(*a, **kw), r,
                          [(r, whole), (k, whole), (v, whole), (logw, whole), (u, {2: 0}), (state0, state)],
                          [whole, state], head_dim=2)
