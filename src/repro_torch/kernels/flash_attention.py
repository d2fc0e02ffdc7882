"""Blocked causal GQA flash attention, forward — wrapper of the CUDA kernel.

``csrc/flash_attention_fwd.cu`` replaces the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``; the source note there says
what bounds it on the card and what the design does about it. This module
checks what the kernel takes, launches it on PyTorch's current stream and
counts the launches. For a tensor on the CPU, and only then, it computes the
same function with the plain version in ``kernels/ref.py``.

Forward only: the backward kernels belong to the training slice of the port.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

#: launches of the CUDA kernel since import (or since the caller reset it)
launch_count = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention_fwd").flash_attention_fwd_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention_fwd takes q (B,KVH,Sq,G,D) and k, v (B,KVH,Skv,D); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, KVH, Sq, G, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, KVH) or k.shape[3] != D:
        raise ValueError(
            f"k, v {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention_fwd needs Sq >= 1 and Skv >= 1")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(
            f"the flash attention kernel takes bfloat16 or float16, not {q.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(
            f"the flash attention kernel is built for head_dim {HEAD_DIMS}, not {D}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        # rows are read with 16-byte loads: last dim contiguous, every other
        # stride a multiple of 8 elements, base pointer 16-byte aligned
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} layout not taken by the flash attention kernel: "
                f"strides {x.stride()}, need last stride 1, others multiples of 8, "
                f"16-byte aligned storage"
            )
    if q.shape[2] * q.shape[3] >= 2**31 or k.shape[2] >= 2**31:
        raise ValueError("the flash attention kernel indexes rows with int32")


def flash_attention_fwd(
    q: torch.Tensor,  # (B, KVH, Sq, G, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,  # (B, KVH, Skv, D)
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o (B,KVH,Sq,G,D) in q's type, lse (B,KVH,Sq,G) f32).

    ``q_offset`` is the absolute position of ``q[:, :, 0]`` for the causal
    mask. The tensors may be strided views (the GQA fold of a (B,S,H,D)
    tensor is one) as long as the last dim is contiguous; ``o`` comes back
    with q's strides, so unfolding it is a view too.
    """
    global launch_count
    _check(q, k, v)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention_fwd has no backward yet: the dk/dv and dq kernels "
            "come with the training slice of the port; call under torch.no_grad()"
        )
    B, KVH, Sq, G, D = q.shape
    Skv = k.shape[2]

    if q.device.type == "cpu":
        qm = q.permute(0, 2, 1, 3, 4).reshape(B, Sq, KVH * G, D)
        o, lse = ref.mha_reference_with_lse(
            qm, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            causal=causal, q_offset=q_offset, scale=scale,
        )
        o = o.reshape(B, Sq, KVH, G, D).permute(0, 2, 1, 3, 4)
        lse = lse.reshape(B, Sq, KVH, G).permute(0, 2, 1, 3).contiguous()
        return o, lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, not {q.device}")

    _check_cuda(q, k, v)
    o = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KVH, Sq, G), dtype=torch.float32, device=q.device)
    strides = (
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *o.stride()[:4],
    )
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            (ctypes.c_longlong * 14)(*strides),
            B, KVH, Sq, Skv, G, D, int(bool(causal)), int(q_offset),
            float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    launch_count += 1
    return o, lse
