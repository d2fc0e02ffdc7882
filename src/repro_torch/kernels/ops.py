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
    (``dist.row_split``), their gradient a partial sum over ``model``. A
    sequence-sharded input is gathered on the sequence, as GSPMD would gather
    it. Where ``model`` does not divide the query heads, each rank takes its
    ``dist.row_split`` share: a group of query heads on a slice of the query
    rows (``q_offset`` moved with it), the outputs gathered whole over
    ``model``. Both ends are differentiable, so ``_Flash`` runs unchanged
    under them;
  * ``decode_attention``: the cache as it is stored, never redistributed.
    Each rank attends over its own cache rows (flash-decode): the decode
    kernel returns its output and log-sum-exp over the valid rows it holds,
    and the partials are merged over the mesh dims that split the sequence
    (``merge_partials``). q's heads are gathered first (B x H x D); where a
    replicated cache meets a ``model`` axis that divides them, the query
    heads are split over it as in ``flash_attention``; where it does not
    divide them, each rank attends with its ``dist.row_split`` share of the
    heads and cache rows, merged over ``model``.
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
        share = dist.row_split(mesh, H, KVH)
        if share is not None and share.parts > 1 and q.shape[1] >= share.parts:
            return _flash_on_row_share(q, k, v, share, causal, scale, q_offset)
        pl_q = dist.kernel_placements(mesh, q.shape[0], (H,), 0, 2)
        pl_kv = dist.kernel_placements(mesh, q.shape[0], (H, KVH), 0, 2)
        ql = dist.to_local_as(q, mesh, pl_q)
        if share is None or share.parts > 1 or pl_kv == pl_q:  # the KV heads replicated with the query heads, or sharded as they are
            kl, vl = (dist.to_local_as(x, mesh, pl_kv) for x in (k, v))
        else:
            kl, vl = (_heads_of_rank(x, mesh, pl_kv, share.kv) for x in (k, v))
        return dist.from_local(_Flash.apply(ql, kl, vl, causal, scale, q_offset), mesh, pl_q)
    return _Flash.apply(q, k, v, causal, scale, q_offset)


def _heads_of_rank(x, mesh, placements, pick, rows: slice = slice(None)) -> torch.Tensor:
    """The heads ``pick`` of ``x`` (B, S, heads, D), replicated over
    ``model``, on ``rows`` of its sequence, as a local tensor: the KV heads
    that this rank's query heads read, or its own query heads (both
    ``dist.row_split``). Its gradient, this rank's part, is a partial
    sum over ``model``."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, placements)]
    local = dist.to_local_as(x, mesh, placements, grad)[:, rows]
    if isinstance(pick, slice):
        return local[:, :, pick].contiguous()
    return local.index_select(2, torch.tensor(pick, device=local.device))


def _flash_on_row_share(q, k, v, share: "dist.RowShare", causal: bool, scale: float, q_offset: int):
    """``flash_attention`` on DTensors where ``model`` does not divide the
    query heads: each rank runs the kernel on its ``dist.row_split`` share,
    its group's query heads on its slice of the query rows (``q_offset``
    moved to the slice's first row) against all the KV rows of the KV heads
    they read. dq, dk and dv come back as partial sums over ``model``, each
    rank's part of them in place. The outputs are gathered over ``model``
    (``_RowShares``), so the result is whole there, as the heads are."""
    mesh = q.device_mesh
    pl = dist.kernel_placements(mesh, q.shape[0], (), 0, None)  # the batch over the data axes, the rest whole
    rows = share.rows(q.shape[1])
    ql = _heads_of_rank(q, mesh, pl, share.heads, rows)
    kl, vl = (_heads_of_rank(x, mesh, pl, share.kv) for x in (k, v))
    o = _Flash.apply(ql, kl, vl, causal, scale, q_offset + rows.start)
    return dist.from_local(_RowShares.apply(o, mesh, share, q.shape[1], pl), mesh, pl)


class _RowShares(torch.autograd.Function):
    """The whole (B, S, H, D) output from each ``model`` rank's
    ``dist.RowShare`` of it (its heads on its rows): one all-gather over
    ``model`` of the shares, each padded to the longest part's rows. In
    backward each rank takes its share of the gradient."""

    @staticmethod
    def forward(ctx, o, mesh, share, S: int, placements):
        from torch.distributed.tensor import Replicate, Shard

        ctx.share, ctx.S = share, S
        B, _, Hg, D = o.shape
        size = -(-S // share.parts)
        padded = torch.nn.functional.pad(o, (0, 0, 0, 0, 0, size - o.shape[1])).contiguous()
        # the shares stacked on dim 0 in ``model``'s order: the gather of a dim 0 sharded there too
        names = mesh.mesh_dim_names
        stacked = [Shard(0) if n == dist.TP_AXIS else pl for n, pl in zip(names, placements)]
        whole = [Replicate() if n == dist.TP_AXIS else pl for n, pl in zip(names, placements)]
        parts = dist.from_local(padded, mesh, stacked).redistribute(mesh, whole).to_local()
        groups = parts.shape[0] // (B * share.parts)
        # (group, part, B, size, Hg, D) -> (B, part, size, H, D): each part's rows with every group's heads
        parts = parts.reshape(groups, share.parts, B, size, Hg, D).permute(2, 1, 3, 0, 4, 5)
        parts = parts.reshape(B, share.parts, size, groups * Hg, D)
        lens = [share.rows(S, p).stop - share.rows(S, p).start for p in range(share.parts)]
        return torch.cat([parts[:, p, :n] for p, n in enumerate(lens)], dim=1)

    @staticmethod
    def backward(ctx, g):
        share = ctx.share
        return g[:, share.rows(ctx.S), share.heads].contiguous(), None, None, None, None


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
    shard of that without moving anything). A mesh dim of more than one rank
    that splits neither the cache nor q (a data axis at batch 1, as the
    long-context cells have it) splits the rank's cache rows further: its
    ranks would otherwise repeat one another's work."""
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
    split, share, pl_q, idle = dist.row_split(mesh, H, KVH), None, [], []
    for i, (name, pl, hp) in enumerate(zip(mesh.mesh_dim_names, kc.placements, heads)):
        if pl.is_shard(0):
            pl_q.append(Shard(0))
        elif pl.is_replicate() and hp.is_shard():  # ``model`` divides the query heads: parts 1
            pl_q.append(hp)
            share = split
        elif pl.is_replicate() or pl.is_shard(1):
            pl_q.append(Replicate())
            if pl.is_replicate() and name == dist.TP_AXIS and split is not None:
                share = split  # ``model`` does not divide the heads: its share of them on a slice of the rows
            elif pl.is_replicate() and mesh.mesh.shape[i] > 1:
                idle.append(i)
        else:
            raise ValueError(f"decode_attention takes caches sharded on the batch or the sequence, not {kc.placements}")
    ql = dist.to_local_as(q, mesh, pl_q)
    kl, vl = kc.to_local(), vc.to_local()
    if share is not None and share.parts == 1:
        kl, vl = kl[:, :, share.kv], vl[:, :, share.kv]
    row0 = dist.shard_rows(kc, 1)[0]
    if idle:  # this rank's part of its rows, the idle dims' coordinates read in mesh order
        part, parts = dist.coordinate_on(mesh, idle)
        n = kl.shape[1]
        mine = slice(part * n // parts, (part + 1) * n // parts)
        kl, vl, row0 = kl[:, mine], vl[:, mine], row0 + mine.start
    squeeze = ql.dim() == 4
    q3 = ql[:, 0] if squeeze else ql
    kv_len = dist.full(kv_len)
    if share is not None and share.parts > 1:
        o = _decode_on_row_share(q3, kl, vl, kv_len, scale, share, mesh, seq + idle, row0)
    elif seq or idle:
        o, lse = da.decode_attention(q3, kl, vl, local_kv_len(kv_len, row0, kl.shape[1]), scale=scale,
                                     return_lse=True)
        o = merge_partials(o, lse, lambda t, op: dist.all_sum(t, mesh, seq + idle, op), q3.dtype)
    else:
        o = da.decode_attention(q3, kl, vl, kv_len, scale=scale)
    return dist.from_local(o[:, None] if squeeze else o, mesh, pl_q)


def _decode_on_row_share(q3, kl, vl, kv_len, scale, share: "dist.RowShare", mesh, seq, row0: int) -> torch.Tensor:
    """The decode over a cache that ``model`` replicates, where it does not
    divide the query heads (whisper-base's cross cache of 1500 frames): each
    rank attends with its ``dist.row_split`` share, its group's heads over its
    slice of the (local) cache rows, and the partials are merged
    (``merge_partials``) over ``model`` and the mesh dims ``seq`` that split
    the rows further (the local rows starting at row ``row0``). Each rank's partial lies in its heads of a whole-head
    tensor, lse −inf in the others, so one merge over ``model`` both adds a
    group's row slices and assembles the heads: the output is whole."""
    B, H, D = q3.shape
    rows = share.rows(kl.shape[1])
    o_part, lse_part = da.decode_attention(
        q3[:, share.heads], kl[:, rows, share.kv], vl[:, rows, share.kv],
        local_kv_len(kv_len, row0 + rows.start, rows.stop - rows.start), scale=scale, return_lse=True)
    o = o_part.new_zeros((B, H, D))
    lse = lse_part.new_full((B, H), float("-inf"))
    o[:, share.heads], lse[:, share.heads] = o_part, lse_part
    dims = [mesh.mesh_dim_names.index(dist.TP_AXIS), *seq]
    return merge_partials(o, lse, lambda t, op: dist.all_sum(t, mesh, dims, op), q3.dtype)


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
