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

Each wrapper also takes DTensors (the sharded steps of ``runtime/``) and
runs the same kernel (or, for a CPU tensor, its plain version) on each rank's
part of the work, where the reference's plan puts it:

  * ``flash_attention``: the batch over the data axes, the query heads over
    ``model`` where it divides them (``sharding.dist.kernel_placements``); the
    KV heads sharded with them where ``model`` divides those too, else sliced
    from the replicated K/V to the heads that the rank's query heads read
    (``dist.head_split``), their gradient a partial sum over ``model``. A
    sequence-sharded input is gathered on the sequence, as GSPMD would gather
    it. Both ends are differentiable, so ``_Flash`` runs unchanged under them;
  * ``decode_attention``: the cache as it is stored, never redistributed.
    Each rank attends over its own cache rows (flash-decode): the decode
    kernel returns its output and log-sum-exp over the valid rows it holds,
    and the partials are merged over the mesh dims that split the sequence
    (``merge_partials``). q's heads are gathered first (B x H x D); where a
    replicated cache meets a ``model`` axis that divides them, the query
    heads are split over it as in ``flash_attention``.
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
        H, KVH = q.shape[2], k.shape[2]
        pl_q = dist.kernel_placements(mesh, q.shape[0], (H,), 0, 2)
        pl_kv = dist.kernel_placements(mesh, q.shape[0], (H, KVH), 0, 2)
        pick = dist.head_split(mesh, H, KVH)
        ql = dist.to_local_as(q, mesh, pl_q)
        if pick is None or pl_kv == pl_q:  # the KV heads replicated with the query heads, or sharded as they are
            kl, vl = (dist.to_local_as(x, mesh, pl_kv) for x in (k, v))
        else:
            kl, vl = (_kv_heads_of_rank(x, mesh, pl_kv, pick) for x in (k, v))
        return dist.from_local(_Flash.apply(ql, kl, vl, causal, scale, q_offset), mesh, pl_q)
    return _Flash.apply(q, k, v, causal, scale, q_offset)


def _kv_heads_of_rank(x, mesh, placements, pick) -> torch.Tensor:
    """The KV heads ``pick`` (``dist.head_split``) of ``x`` (B, S, KVH, D),
    replicated over ``model``, as a local tensor; its gradient, the part of
    this rank's query heads, a partial sum over ``model``."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, placements)]
    local = dist.to_local_as(x, mesh, placements, grad)
    if isinstance(pick, slice):
        return local[:, :, pick].contiguous()
    return local.index_select(2, torch.tensor(pick, device=local.device))


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) or (B, H, D)
    k_cache: torch.Tensor,  # (B, Smax, KVH, D)
    v_cache: torch.Tensor,  # (B, Smax, KVH, D)
    *,
    kv_len: Union[torch.Tensor, int],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention; returns q-shaped output."""
    if dist.is_dtensor(q) or dist.is_dtensor(k_cache):
        return _decode_on_shards(q, k_cache, v_cache, kv_len, scale)
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    out = da.decode_attention(q3, k_cache, v_cache, kv_len, scale=scale)
    return out[:, None] if squeeze else out


def local_kv_len(kv_len: Union[torch.Tensor, int], row0: int, rows: int) -> Union[torch.Tensor, int]:
    """The valid rows of a shard of ``rows`` cache rows starting at ``row0``:
    ``clamp(kv_len - row0, 0, rows)``, on the device for a tensor (no host sync)."""
    if isinstance(kv_len, torch.Tensor):
        return (kv_len - row0).clamp(0, rows)
    return max(0, min(int(kv_len) - row0, rows))


def merge_partials(o: torch.Tensor, lse: torch.Tensor, reduce, dtype: torch.dtype) -> torch.Tensor:
    """Flash-decode's merge: ``o`` (..., D) and ``lse`` (...), both f32, of
    the attention over one shard of the cache's rows, ``reduce(t, op)`` (op
    "max" or "sum") reducing over the shards. m = max lse; the output is
    Σ e^(lse−m)·o / Σ e^(lse−m), rounded once to ``dtype``. A shard with no
    valid row (o = 0, lse = −inf) adds nothing; where no shard has one the
    output is 0, never NaN. One reduction of the weighted outputs and their
    weights."""
    m = reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    both = reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1), "sum")
    return (both[..., :-1] / both[..., -1:].clamp_min(1e-30)).to(dtype)


def _decode_on_shards(q, k_cache, v_cache, kv_len, scale) -> torch.Tensor:
    """``decode_attention`` on DTensors (module docstring): each rank on its
    own cache rows and batch, merged over the mesh dims that split the
    sequence; the output in q's batch placements and, where split, its
    heads over ``model``, replicated elsewhere (``decode_heads`` takes its
    shard of that without moving anything)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = (q if dist.is_dtensor(q) else k_cache).device_mesh
    kc, vc = (x if dist.is_dtensor(x) else dist.from_local(x, mesh, [Replicate()] * mesh.ndim)
              for x in (k_cache, v_cache))
    if list(kc.placements) != list(vc.placements):
        raise ValueError(f"the K and V caches lie in other placements: {kc.placements}, {vc.placements}")
    hd = q.dim() - 2
    H, KVH = q.shape[hd], kc.shape[2]
    heads = dist.kernel_placements(mesh, q.shape[0], (H,), None, hd)
    seq = dist.sharded_on(kc, 1)
    pl_q, pick = [], None
    for pl, hp in zip(kc.placements, heads):
        if pl.is_shard(0):
            pl_q.append(Shard(0))
        elif pl.is_replicate() and hp.is_shard():
            pl_q.append(hp)
            pick = dist.head_split(mesh, H, KVH)
        elif pl.is_replicate() or pl.is_shard(1):
            pl_q.append(Replicate())
        else:
            raise ValueError(f"decode_attention takes caches sharded on the batch or the sequence, not {kc.placements}")
    ql = dist.to_local_as(q, mesh, pl_q)
    kl, vl = kc.to_local(), vc.to_local()
    if pick is not None:
        kl, vl = kl[:, :, pick], vl[:, :, pick]
    squeeze = ql.dim() == 4
    q3 = ql[:, 0] if squeeze else ql
    kv_len = dist.full(kv_len)
    if seq:
        row0, rows = dist.shard_rows(kc, 1)
        o, lse = da.decode_attention(q3, kl, vl, local_kv_len(kv_len, row0, rows), scale=scale, return_lse=True)
        o = merge_partials(o, lse, lambda t, op: dist.all_sum(t, mesh, seq, op), q3.dtype)
    else:
        o = da.decode_attention(q3, kl, vl, kv_len, scale=scale)
    return dist.from_local(o[:, None] if squeeze else o, mesh, pl_q)


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
