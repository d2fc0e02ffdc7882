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
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

#: head dims of the forward kernel (K1); the backward kernels (K2, K3) are
#: built for BWD_HEAD_DIMS, and a backward at another head dim raises
HEAD_DIMS = (64, 112, 128, 160)
BWD_HEAD_DIMS = (64, 128, 160)
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
            + [ctypes.c_int] * 11
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
        tail = [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dq.argtypes = dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + tail
        dq.restype = dkv.restype = ctypes.c_int
        _bwd_fns = (dkv, dq)
    return _bwd_fns


#: the backward kernels' tiles: the dq kernel owns 128 folded q rows a block;
#: the dk/dv kernel sweeps q tiles of 64 folded rows (the KV rows it owns are
#: ``dkv_kv_rows(D)``)
DQ_TILE_ROWS, DKV_TILE_ROWS = 128, 64


def fwd_tile_rows(D: int) -> int:
    """Folded q rows a block of the forward kernel owns at head_dim D: 64 a
    consumer warpgroup, three of them at D = 64 and 112 and two at D = 128 and 160
    (``FwdSmem<D>::QR`` in the source; a launch whose plan disagrees fails
    with ERR_PLAN)."""
    return 192 if D in (64, 112) else 128


def dkv_kv_rows(D: int) -> int:
    """KV rows a block of the dk/dv kernel owns at head_dim D
    (``dkv_own_rows<D>`` in the source): 128, 64 a consumer warpgroup; 64 at
    D = 160, where one warpgroup holds their dv and the other their dk."""
    return 64 if D == 160 else 128


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Which folded rows make one q tile of a flash kernel.

    A tile is ``positions`` query positions x ``groups`` query heads of one KV
    head, row = position * groups + group, read by ceil(D / 64) TMA boxes of
    ``box`` = (64, groups, positions, 1, 1) elements over (D, G, S, KVH, B),
    one a 64-element column block; the tensor map's extent of D clips the
    last box where 64 does not divide D (112, 160).
    With G <= rows a tile holds whole positions (``groups`` = G); with
    G > rows it holds one position and the G heads span ``g_chunks`` tiles.
    The ``rows_masked`` rows past positions x groups are never loaded and
    read as 0.
    """

    rows: int
    positions: int
    groups: int
    g_chunks: int

    @property
    def rows_used(self) -> int:
        return self.positions * self.groups

    @property
    def rows_masked(self) -> int:
        return self.rows - self.rows_used

    @property
    def box(self) -> Tuple[int, int, int, int, int]:
        return (64, self.groups, self.positions, 1, 1)

    def n_tiles(self, Sq: int) -> int:
        return -(-Sq // self.positions) * self.g_chunks


def tile_plan(G: int, rows: int) -> TilePlan:
    """The tile plan of ``rows`` folded rows at G query heads per KV head."""
    if G < 1 or rows < 1:
        raise ValueError(f"tile_plan needs G >= 1 and rows >= 1, not {G}, {rows}")
    if G <= rows:
        return TilePlan(rows, rows // G, G, 1)
    return TilePlan(rows, 1, rows, -(-G // rows))


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


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dims=HEAD_DIMS, what: str = "forward",
                **more: torch.Tensor) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(
            f"the flash attention kernel takes bfloat16 or float16, not {q.dtype}"
        )
    if D not in head_dims:
        raise ValueError(
            f"the flash attention {what} kernels are built for head_dim {head_dims}, not {D}"
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


def _check_tma(**named: torch.Tensor) -> None:
    """What the kernels' tensor maps need beyond ``_check_cuda``: TMA steps
    every dim with more than one entry by a positive stride."""
    for name, x in named.items():
        if any(st <= 0 for st, n in zip(x.stride(), x.shape) if n > 1):
            raise ValueError(f"{name} layout not taken by the tensor maps of the flash kernels: strides {x.stride()}")


def flash_attention_fwd(
    q: torch.Tensor,  # (B, KVH, Sq, G, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,  # (B, KVH, Skv, D)
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o (B,KVH,Sq,G,D) in q's type, lse (B,KVH,Sq,G) f32).

    ``q_offset`` is the absolute position of ``q[:, :, 0]`` for the causal
    mask. The tensors may be strided views (the GQA fold of a (B,S,H,D)
    tensor is one) as long as the last dim is contiguous; ``o`` comes back
    with q's strides, so unfolding it is a view too. ``out``, if given, is
    the tensor (shaped like q, any layout the kernel takes) that o is
    written to and returned as; on the CPU it is filled with the plain
    version's o.
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
        return (o if out is None else out.copy_(o)), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, not {q.device}")

    o = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device) if out is None else out
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"out {tuple(o.shape)} {o.dtype} must have q's shape, type and device")
    _check_cuda(q, k, v, o=o)
    _check_tma(q=q, k=k, v=v, o=o)
    plan = tile_plan(G, fwd_tile_rows(D))
    if plan.n_tiles(Sq) * KVH * B >= 2**31:
        raise ValueError("the flash forward kernel numbers its work items (q tile, kv head, batch) with int32")
    lse = torch.empty((B, KVH, Sq, G), dtype=torch.float32, device=q.device)
    strides = (
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *o.stride()[:4],
    )
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            (ctypes.c_longlong * 14)(*strides),
            B, KVH, Sq, Skv, G, D, plan.positions, plan.groups, plan.g_chunks,
            int(bool(causal)), int(q_offset), float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "forward")
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

    On the card: one launch of the dq kernel, which also computes
    ``delta = sum_d o * do`` for its rows (the reference computes it outside
    its kernels), then one of the dk/dv kernel, which reads that delta. dq is
    allocated with q's strides and dk, dv with k's and v's, so unfolding them
    is a view, as for ``o`` in the forward.
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
    delta = torch.empty((B, KVH, Sq, G), dtype=torch.float32, device=q.device)
    dq = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
    dk = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype, device=k.device)
    dv = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device=v.device)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    launch_bwd_dq(q, k, v, o, do, lse, delta, dq, **kw)
    launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, **kw)
    return dq, dk, dv


def _bwd_args(q, k, v, lse, delta, named, rows, causal, scale, q_offset):
    """Checks shared by the two backward launches, all made before any CUDA
    call; returns the ctypes arguments after the pointers and before the
    stream (strides, shapes, tile plan, flags).

    ``named`` holds the kernel's other 16-bit tensors in the order of its
    strides: o, do, dq for the dq kernel; do, dk, dv for the dk/dv kernel.
    """
    _check(q, k, v)
    B, KVH, Sq, G, D = q.shape
    Skv = k.shape[2]
    plan = tile_plan(G, rows)
    for name, x in named.items():
        like = k if name in ("dk", "dv") else q
        if x.shape != like.shape:
            raise ValueError(f"{name} {tuple(x.shape)} must be shaped like {tuple(like.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name} must have q's type and device")
    _check_cuda(q, k, v, BWD_HEAD_DIMS, "backward", **named)
    _check_tma(q=q, k=k, v=v, **named)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B, KVH, Sq, G) or x.dtype != torch.float32 or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 (B,KVH,Sq,G) tensor on q's device")
    if plan.n_tiles(Sq) > 65535 or -(-Skv // dkv_kv_rows(D)) > 65535 or B > 65535:
        raise ValueError("the flash backward kernels put the tile index on a grid axis of at most 65535")
    if q.device.type != "cuda":
        raise ValueError(f"the flash backward launches take CUDA tensors, not {q.device}")
    strides = [st for x in (q, k, v, *named.values()) for st in x.stride()[:-1]]
    return (
        (ctypes.c_longlong * len(strides))(*strides), B, KVH, Sq, Skv, G, D,
        plan.positions, plan.groups, plan.g_chunks,
        int(bool(causal)), int(q_offset), float(scale), _DTYPES[q.dtype],
    )


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        why = _build.LAUNCH_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash attention {what} kernel launch failed: {why}")


def launch_bwd_dq(q, k, v, o, do, lse, delta, dq, *, causal: bool, scale: float, q_offset: int = 0) -> None:
    """One launch of the dq kernel (CUDA tensors only): fills ``dq`` and
    ``delta`` = sum_d o * do, (B,KVH,Sq,G) f32, which the dk/dv kernel reads."""
    global dq_launch_count
    args = _bwd_args(q, k, v, lse, delta, {"o": o, "do": do, "dq": dq}, DQ_TILE_ROWS, causal, scale, q_offset)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *args, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "dq")
    dq_launch_count += 1


def launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, *, causal: bool, scale: float, q_offset: int = 0) -> None:
    """One launch of the dk/dv kernel (CUDA tensors only): fills ``dk`` and
    ``dv``. ``delta`` is what ``launch_bwd_dq`` wrote, on the same stream."""
    global dkv_launch_count
    args = _bwd_args(q, k, v, lse, delta, {"do": do, "dk": dk, "dv": dv}, DKV_TILE_ROWS, causal, scale, q_offset)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "dk/dv")
    dkv_launch_count += 1
