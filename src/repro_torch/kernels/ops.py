"""Public wrappers around the CUDA kernels with the model-API layout.

The model API uses (B, S, H, D); the flash kernel uses the GQA-folded
(B, KVH, S, G, D). The folds are views: the kernel addresses its tensors
through strides, so no copy is made on the way in or out.

There is no execution-mode switch: a tensor on the card goes to the kernel
(or the call raises), a tensor on the CPU goes to the kernel's plain version
in ``ref.py``. ``flash_attention`` is differentiable: a
``torch.autograd.Function`` runs the forward kernel and, in backward, the dq
and dk/dv kernels, the twin of the reference's ``_flash`` under
``custom_vjp``. The decode kernel has no backward, here as in the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa


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
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    out = da.decode_attention(q3, k_cache, v_cache, kv_len, scale=scale)
    return out[:, None] if squeeze else out
