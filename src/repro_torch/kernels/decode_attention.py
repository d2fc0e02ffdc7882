"""Single-query decode attention over a KV cache — wrapper of the CUDA kernel.

``csrc/decode_attention.cu`` replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``; the source note there
says what bounds it on the card and what the design does about it. This
module checks what the kernel takes, chooses how many blocks of a thread block
cluster share the sweep of one (batch, kv head) (from the shapes alone),
allocates the output, launches on PyTorch's current stream and counts the
launches. For a tensor on the CPU, and only then, it computes the same
function with the plain version in ``kernels/ref.py``. While an op counter is
active each launch reports its work (``record_launch``): the valid cache
rows, q and the output, and 4·D FLOPs per valid row and query head.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.telemetry import counts

HEAD_DIMS = (64, 112, 128, 160)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
#: cache rows below which a further split of the sweep is not worth a block:
#: at batch 1 of granite-3-2b splits of 4 tiles (64 rows each) were faster
#: than splits of 2, at (1,4096,2,64) splits of 4 faster than splits of 8
#: (an H100, PERF.md)
MIN_ROWS_PER_SPLIT = 256
#: blocks per SM the split aims for: fewer, longer splits were faster on an
#: H100 (clusters of 2 against 4 and 8 at the serving shape, PERF.md)
BLOCKS_PER_SM = 1
#: the most blocks of one cluster (the non-portable cluster size of Hopper),
#: so that a few long sweeps still spread over the card
MAX_SPLITS = 16

#: calls that launched the CUDA kernel since import (or since the caller reset it)
launch_count = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


#: query heads of one kv head that one block handles (the rows of its
#: 16-row tensor-core tiles that are not padding); a larger group takes
#: several blocks
HEADS_PER_BLOCK = 8


def n_splits(B: int, KVH: int, G: int, Smax: int, n_sm: int) -> int:
    """How many blocks of one cluster share the KV sweep of one (batch, kv head).

    Fixed by the shapes and the SM count, never by ``kv_len`` (which lives on
    the device): the largest power of two up to ``MAX_SPLITS`` that leaves
    every SM at most ``BLOCKS_PER_SM`` blocks, with no split shorter than
    ``MIN_ROWS_PER_SPLIT`` cache rows.
    """
    blocks = B * KVH * (-(-G // HEADS_PER_BLOCK))
    ns = 1
    while (2 * ns <= MAX_SPLITS and blocks * 2 * ns <= BLOCKS_PER_SM * n_sm
           and 2 * ns <= -(-Smax // MIN_ROWS_PER_SPLIT)):
        ns *= 2
    return ns


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


def _check_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, out: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the decode attention kernel takes bfloat16 or float16, not {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the decode attention kernel is built for head_dim {HEAD_DIMS}, not {D}")
    if out.shape != q.shape or out.dtype != out_dtype or out.device != q.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} must have q's shape and device, type {out_dtype}")
    for name, x in (("q", q), ("out", out), ("k_cache", k_cache), ("v_cache", v_cache)):
        # TMA reads the cache where it lies, and q and out are read and
        # written where they lie: last dim contiguous, every other stride a
        # positive multiple of 8 elements (16 bytes) where its dim has more
        # than one entry, storage 16-byte aligned. So the first D columns of a
        # wider buffer are taken as they are.
        if (x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16
                or any(s <= 0 for s, n in zip(x.stride(), x.shape) if n > 1)):
            raise ValueError(
                f"{name} layout not taken by the decode attention kernel: strides "
                f"{x.stride()}, need last stride 1, others positive multiples of 8, 16-byte aligned storage"
            )


def flops(B: int, H: int, D: int, kv_len: int) -> int:
    """The decode kernel's (K4) product FLOPs: q·k and p·v, 4·D per valid
    cache row and query head."""
    return 4 * D * B * H * kv_len


def record_launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, kv_len: Union[torch.Tensor, int],
                  *outs: torch.Tensor) -> None:
    """Report one launch to the active op counters, if any: q and the
    caches' valid rows read, ``outs`` (the output, and the log-sum-exp where
    asked for) written. A device ``kv_len`` is read on the host here, and the
    valid rows sliced, outside the counters' sight."""
    if not counts.recording():
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        n = int(kv_len.reshape(()).item() if isinstance(kv_len, torch.Tensor) else kv_len)
        valid = [k_cache[:, :n], v_cache[:, :n]]
    B, H, D = q.shape
    counts.record_kernel("decode_attention", [q, *valid], list(outs), flops(B, H, D, n))


def decode_attention(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    kv_len: Union[torch.Tensor, int],  # valid cache entries: int, or 1-element int32 tensor
    *,
    scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Returns (B, H, D) attention output in q's type; with ``return_lse``
    flash-decode's partial instead: the output in f32, so that a merge of
    partials rounds once, and the (B, H) f32 log-sum-exp of the scaled scores
    over the valid rows (−inf, and o = 0, where no row is valid).

    On the card ``kv_len`` reaches the kernel as a 1-element int32 device
    tensor; pass one to change the length between launches with no host sync.
    A Python int is wrapped into one. ``out``, if given, is the (B, H, D)
    tensor the kernel writes and returns (it may be a view into a wider
    buffer); on the CPU it is filled with the plain version's result.
    """
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
        res = ref.decode_attention_reference(q, k_cache, v_cache, kv_len=kv_len, scale=scale, return_lse=return_lse)
        o, lse = res if return_lse else (res, None)
        o = o if out is None else out.copy_(o)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")

    out_dtype = torch.float32 if return_lse else q.dtype
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device) if out is None else out
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    _check_cuda(q, k_cache, v_cache, out, out_dtype)
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype != torch.int32 or kv_len.device != q.device:
            raise ValueError(
                "kv_len tensor must hold one int32 on q's device; got "
                f"{tuple(kv_len.shape)} {kv_len.dtype} on {kv_len.device}"
            )
    else:
        kv_len = torch.tensor([int(kv_len)], dtype=torch.int32, device=q.device)

    ns = n_splits(B, KVH, H // KVH, Smax, _build.sm_count(q.device.index))
    strides = (*k_cache.stride()[:3], *v_cache.stride()[:3], *q.stride()[:2], *out.stride()[:2])
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            (ctypes.c_longlong * 10)(*strides),
            B, H, KVH, D, Smax, ns, float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        why = _build.LAUNCH_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"decode_attention kernel launch failed: {why}")
    _build.count_launch(globals(), "launch_count")
    outs = (out,) if lse is None else (out, lse)
    record_launch(q, k_cache, v_cache, kv_len, *outs)
    return out if lse is None else outs
