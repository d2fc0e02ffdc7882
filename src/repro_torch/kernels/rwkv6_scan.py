"""Chunked WKV6 (RWKV-6 'Finch') linear-attention scan — wrapper of the CUDA kernel.

``csrc/wkv6_scan.cu`` replaces the TPU kernel
``repro/kernels/rwkv6_scan.py::_wkv6_kernel``; the source note there says what
bounds it on the card and what the design does about it. This module checks
what the kernel takes, copies an input whose rows do not start on 16 bytes,
allocates the outputs, picks how many blocks share the value columns of one
(batch, head), launches on PyTorch's current stream and counts the launches. For a tensor on the CPU, and only then, it computes the
same function with the plain version ``kernels/ref.py::wkv6_reference``.
The kernel has no backward: on the card a call that autograd would have to
differentiate raises. While an op counter is active each launch reports its
work (``record_launch``): its operands and outputs, and the products of the
recurrence, 4·K² a (token, head).

Unlike the reference, which raises when ``T`` is not a multiple of the chunk,
the kernel masks a short last chunk: any ``T >= 1`` is taken.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.telemetry import counts

HEAD_SIZE = 64
CHUNK = 64
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: launches of the CUDA kernel since import (or since the caller reset it)
launch_count = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("wkv6_scan").wkv6_scan_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def n_splits(B: int, H: int, n_sm: int) -> int:
    """Blocks that share the V columns of one (batch, head): 1, 2 or 4.

    The fewest that give every SM a block; each extra slice recomputes the
    chunk's pairwise scores, so no more than that.
    """
    for n in (1, 2):
        if B * H * n >= n_sm:
            return n
    return 4


def aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy of it where it or one of its rows (a step
    of its first three dims) does not start on 16 bytes: the kernel loads
    rows by 16-byte ``cp.async``."""
    e = x.element_size()
    if x.data_ptr() % 16 == 0 and all(st * e % 16 == 0 for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(r, k, v, logw, u, state0) -> None:
    if r.dim() != 4 or k.shape != r.shape or logw.shape != r.shape or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(
            "wkv6_scan takes r, k, logw (B,T,H,K) and v (B,T,H,V); got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}"
        )
    B, T, H, K = r.shape
    V = v.shape[-1]
    if u.shape != (H, K) or state0.shape != (B, H, K, V):
        raise ValueError(f"u {tuple(u.shape)} must be {(H, K)} and state0 {tuple(state0.shape)} {(B, H, K, V)}")
    if len({x.device for x in (r, k, v, logw, u, state0)}) != 1:
        raise ValueError("r, k, v, logw, u and state0 lie on different devices")


def _check_cuda(r, k, v, logw, u, state0) -> None:
    B, T, H, K = r.shape
    if K != HEAD_SIZE or v.shape[-1] != HEAD_SIZE:
        raise ValueError(f"the wkv6 kernel is built for head size {HEAD_SIZE}, not K={K}, V={v.shape[-1]}")
    if T < 1:
        raise ValueError("the wkv6 kernel needs T >= 1")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"r, k, v must share one type of bfloat16 or float32; got {r.dtype}, {k.dtype}, {v.dtype}")
    if not (logw.dtype == u.dtype == state0.dtype == torch.float32):
        raise TypeError(f"logw, u and state0 must be float32; got {logw.dtype}, {u.dtype}, {state0.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the wkv6 kernel needs the last dim contiguous; strides {x.stride()}")
    for name, x in (("u", u), ("state0", state0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the wkv6 kernel; strides {x.stride()}")
    if B > 65535 or H > 65535:
        raise ValueError("the wkv6 kernel puts batch and head on grid axes of at most 65535")


def flops(B: int, T: int, H: int) -> int:
    """The WKV6 kernel's (K5) product FLOPs: the recurrence's r_t·S and
    k_t v_t^T, 2·K² each a (token, head), which the chunked form does as
    matrix products (K = V = HEAD_SIZE)."""
    return 4 * HEAD_SIZE * HEAD_SIZE * B * T * H


def record_launch(r, k, v, logw, u, state0, out, state) -> None:
    """Report one launch to the active op counters, if any: r, k, v, logw,
    u and state0 read, out and the final state written."""
    if counts.recording():
        B, T, H, _ = r.shape
        counts.record_kernel("wkv6_scan", [r, k, v, logw, u, state0], [out, state], flops(B, T, H))


def wkv6_scan(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K) log-decay <= 0
    u: torch.Tensor,  # (H, K) bonus
    state0: torch.Tensor,  # (B, H, K, V)
    *,
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,T,H,V) f32, final state (B,H,K,V) f32).

    ``chunk`` is part of the reference's signature; the kernel is built for
    chunks of 64 and raises for any other.
    """
    _check(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return ref.wkv6_reference(r, k, v, logw, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan runs on cuda or cpu tensors, not {r.device}")
    if chunk != CHUNK:
        raise ValueError(f"the wkv6 kernel is built for chunks of {CHUNK}, not {chunk}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, logw, u, state0)):
        raise NotImplementedError(
            "the wkv6 kernel has no backward (nor has the reference's); "
            "call it under torch.no_grad() or with inputs that need no gradient"
        )

    _check_cuda(r, k, v, logw, u, state0)
    r, k, v, logw = (aligned_rows(x) for x in (r, k, v, logw))
    B, T, H, K = r.shape
    out = torch.empty((B, T, H, K), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    strides = (*r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3])
    with torch.cuda.device(r.device):
        err = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            state0.data_ptr(), out.data_ptr(), state.data_ptr(),
            (ctypes.c_longlong * 12)(*strides),
            B, T, H, n_splits(B, H, _build.sm_count(r.device.index)), _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_scan kernel launch failed: CUDA error {err}")
    _build.count_launch(globals(), "launch_count")
    record_launch(r, k, v, logw, u, state0, out, state)
    return out, state
