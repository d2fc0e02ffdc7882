"""Blocked causal GQA flash attention, forward and backward — wrappers of the
CUDA kernels.

``csrc/flash_attention_fwd.cu`` replaces the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``; ``csrc/flash_attention_bwd.cu``
replaces its two backward kernels, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``.
The source notes there say what bounds each on the card and what the design
does about it. This module checks what the kernels take, launches them on
PyTorch's current stream and counts the launches. For a tensor on the CPU, and
only then, it computes the same functions with the plain versions in
``kernels/ref.py``. ``kernels/ops.py`` wires the two directions together as a
``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

#: launches of the forward kernel since import (or since the caller reset it)
launch_count = 0
#: launches of the dk/dv and of the dq backward kernel, counted the same way
dkv_launch_count = 0
dq_launch_count = 0

_fn = None
_bwd_fns = None


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


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load("flash_attention_bwd")
        dq, dkv = lib.flash_attention_bwd_dq_launch, lib.flash_attention_bwd_dkv_launch
        tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + tail
        dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + tail
        dq.restype = dkv.restype = ctypes.c_int
        _bwd_fns = (dkv, dq)
    return _bwd_fns


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


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **more: torch.Tensor) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(
            f"the flash attention kernel takes bfloat16 or float16, not {q.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(
            f"the flash attention kernel is built for head_dim {HEAD_DIMS}, not {D}"
        )
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
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


def flash_attention_bwd(
    q: torch.Tensor,  # (B, KVH, Sq, G, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,  # (B, KVH, Skv, D)
    o: torch.Tensor,  # (B, KVH, Sq, G, D), the forward's output
    lse: torch.Tensor,  # (B, KVH, Sq, G) f32, the forward's row log-sum-exp
    do: torch.Tensor,  # (B, KVH, Sq, G, D), the gradient of o
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv) in the layouts and types of (q, k, v).

    On the card: ``delta = sum_d o * do`` in plain PyTorch (as the reference
    computes it outside its kernels), then one launch of the dq kernel and
    one of the dk/dv kernel. dq is allocated with q's strides and dk, dv with
    k's and v's, so unfolding them is a view, as for ``o`` in the forward.
    """
    _check(q, k, v)
    B, KVH, Sq, G, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, KVH, Sq, G):
        raise ValueError(
            f"o {tuple(o.shape)}, do {tuple(do.shape)} must match q {tuple(q.shape)} and "
            f"lse {tuple(lse.shape)} must be {(B, KVH, Sq, G)}"
        )
    if lse.dtype != torch.float32 or do.dtype != q.dtype or o.dtype != q.dtype:
        raise TypeError(f"lse must be float32 and o, do of q's type: {lse.dtype}, {o.dtype}, {do.dtype}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("q, o, lse, do devices differ")

    if q.device.type == "cpu":
        return ref.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale, q_offset=q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")

    lse = lse.contiguous()
    delta = (o.float() * do.float()).sum(dim=-1).contiguous()
    dq = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
    dk = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype, device=k.device)
    dv = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device=v.device)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    launch_bwd_dq(q, k, v, do, lse, delta, dq, **kw)
    launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, **kw)
    return dq, dk, dv


def _bwd_args(q, k, v, do, lse, delta, dq, dk, dv, causal, scale, q_offset):
    """Checks shared by the two backward launches; returns the ctypes arguments."""
    B, KVH, Sq, G, D = q.shape
    Skv = k.shape[2]
    _check(q, k, v)
    if (do.shape, dq.shape, dk.shape, dv.shape) != (q.shape, q.shape, k.shape, v.shape):
        raise ValueError("do and dq must be shaped like q, dk like k and dv like v")
    if any(x.dtype != q.dtype or x.device != q.device for x in (do, dq, dk, dv)):
        raise TypeError("do, dq, dk and dv must have q's type and device")
    _check_cuda(q, k, v, do=do, dq=dq, dk=dk, dv=dv)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B, KVH, Sq, G) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 (B,KVH,Sq,G) tensor")
    if -(-Sq * G // 64) > 65535 or -(-Skv // 64) > 65535 or B > 65535:
        raise ValueError("the flash backward kernels put the tile index on a grid axis of at most 65535")
    strides = (
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *do.stride()[:4],
        *dq.stride()[:4], *dk.stride()[:3], *dv.stride()[:3],
    )
    return (
        (ctypes.c_longlong * 24)(*strides), B, KVH, Sq, Skv, G, D,
        int(bool(causal)), int(q_offset), float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )


def launch_bwd_dq(q, k, v, do, lse, delta, dq, *, causal: bool, scale: float, q_offset: int = 0) -> None:
    """One launch of the dq kernel (CUDA tensors only): fills ``dq``."""
    global dq_launch_count
    with torch.cuda.device(q.device):
        args = _bwd_args(q, k, v, do, lse, delta, dq, k, v, causal, scale, q_offset)
        err = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *args,
        )
    if err != 0:
        raise RuntimeError(f"flash attention dq kernel launch failed: CUDA error {err}")
    dq_launch_count += 1


def launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, *, causal: bool, scale: float, q_offset: int = 0) -> None:
    """One launch of the dk/dv kernel (CUDA tensors only): fills ``dk`` and ``dv``."""
    global dkv_launch_count
    with torch.cuda.device(q.device):
        args = _bwd_args(q, k, v, do, lse, delta, q, dk, dv, causal, scale, q_offset)
        err = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args,
        )
    if err != 0:
        raise RuntimeError(f"flash attention dk/dv kernel launch failed: CUDA error {err}")
    dkv_launch_count += 1
