"""Single-query decode attention over a KV cache — wrapper of the CUDA kernel.

``csrc/decode_attention.cu`` replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``; the source note there
says what bounds it on the card and what the design does about it. This
module checks what the kernel takes, allocates the output and the scratch of
the split KV sweep, launches on PyTorch's current stream and counts the
launches. For a tensor on the CPU, and only then, it computes the same
function with the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
#: kv rows below which a further split of the sweep is not worth a block
MIN_ROWS_PER_SPLIT = 128
#: blocks per SM the split aims for
BLOCKS_PER_SM = 4

#: calls that launched the CUDA kernel since import (or since the caller reset it)
launch_count = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def heads_per_block(G: int) -> int:
    """Query heads of one kv head that one block handles (the kernel has 1, 2, 4, 8)."""
    return 8 if G >= 8 else (4 if G > 2 else (2 if G > 1 else 1))


def n_splits(B: int, KVH: int, G: int, Smax: int, n_sm: int) -> int:
    """How many blocks share the KV sweep of one (batch, kv head).

    Fixed by the shapes, never by ``kv_len`` (which lives on the device):
    enough blocks to give every SM ``BLOCKS_PER_SM`` of them, but no split
    shorter than ``MIN_ROWS_PER_SPLIT`` cache rows.
    """
    blocks = B * KVH * (-(-G // heads_per_block(G)))
    want = -(-BLOCKS_PER_SM * n_sm // blocks)
    return max(1, min(want, -(-Smax // MIN_ROWS_PER_SPLIT)))


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(
            f"decode_attention takes q (B,H,D) and caches (B,Smax,KVH,D); got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, H, D = q.shape
    Bc, Smax, KVH, Dc = k_cache.shape
    if k_cache.shape != v_cache.shape or Bc != B or Dc != D or H % KVH or Smax < 1:
        raise ValueError(
            f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not match q {tuple(q.shape)}"
        )
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q and cache types differ: {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches lie on different devices")


def _check_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the decode attention kernel takes bfloat16 or float16, not {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the decode attention kernel is built for head_dim {HEAD_DIMS}, not {D}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"q must be contiguous and 16-byte aligned; strides {q.stride()}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        # the cache is read where it lies, 16 bytes a lane: last dim contiguous,
        # every other stride a multiple of 8 elements, storage 16-byte aligned
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} layout not taken by the decode attention kernel: strides "
                f"{x.stride()}, need last stride 1, others multiples of 8, 16-byte aligned storage"
            )


def decode_attention(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    kv_len: Union[torch.Tensor, int],  # valid cache entries: int, or 1-element int32 tensor
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, D) attention output in q's type.

    On the card ``kv_len`` reaches the kernel as a 1-element int32 device
    tensor; pass one to change the length between launches with no host sync.
    A Python int is wrapped into one.
    """
    global launch_count
    _check(q, k_cache, v_cache)
    if q.requires_grad or k_cache.requires_grad or v_cache.requires_grad:
        raise NotImplementedError(
            "decode_attention is a serving kernel and has no backward; "
            "call under torch.no_grad()"
        )
    B, H, D = q.shape
    _, Smax, KVH, _ = k_cache.shape
    scale = D**-0.5 if scale is None else scale

    if q.device.type == "cpu":
        return ref.decode_attention_reference(q, k_cache, v_cache, kv_len=kv_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")

    _check_cuda(q, k_cache, v_cache)
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype != torch.int32 or kv_len.device != q.device:
            raise ValueError(
                "kv_len tensor must hold one int32 on q's device; got "
                f"{tuple(kv_len.shape)} {kv_len.dtype} on {kv_len.device}"
            )
    else:
        kv_len = torch.tensor([int(kv_len)], dtype=torch.int32, device=q.device)

    ns = n_splits(B, KVH, H // KVH, Smax, _build.sm_count(q.device.index))
    out = torch.empty_like(q)
    # scratch of the split sweep, one allocation: acc (B,H,ns,D), then m and l (B,H,ns) each
    slots = B * H * ns
    part = torch.empty(slots * (D + 2), dtype=torch.float32, device=q.device)
    part_acc = part.data_ptr()
    part_m = part_acc + 4 * slots * D
    part_l = part_m + 4 * slots
    strides = (*k_cache.stride()[:3], *v_cache.stride()[:3])
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part_acc, part_m, part_l,
            (ctypes.c_longlong * 6)(*strides),
            B, H, KVH, D, Smax, heads_per_block(H // KVH), ns, float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out
