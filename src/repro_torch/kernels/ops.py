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
    ``dist.row_split`` share: a group of query heads on its part of the query
    rows (under a causal mask a zig-zag of two slices, which evens the live
    pairs; a call a slice, ``q_offset`` moved with it), and one all-to-all
    over ``model`` takes the outputs to ``wo``'s row layout (``RowsToWo``):
    (B, S, H·D), its columns sharded, the one layout of the output there
    (``flat``; the models always ask for it). Both ends are differentiable,
    so ``_Flash`` runs unchanged under them;
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

import dataclasses
from typing import List, Optional, Tuple, Union

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
    flat: bool = False,
) -> torch.Tensor:
    """GQA flash attention with the model-API layout. Differentiable.
    ``flat``: the output as (B, Sq, H·D), ``wo``'s input. On the row shares
    (``_flash_on_row_share``) that is the only layout: the exchange lands
    there, and the (B, Sq, H, D) view cannot express it where ``model``
    does not divide H, so a call there without ``flat`` raises."""
    B, S, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    if dist.is_dtensor(q):
        mesh = q.device_mesh
        KVH = k.shape[2]
        share = dist.row_split(mesh, H, KVH)
        if share is not None and share.parts > 1 and S >= share.parts:
            if not flat:
                raise ValueError(f"model does not divide the {H} query heads: the row shares' output "
                                 "exists only as wo's input (B, S, H·D); pass flat=True")
            return _flash_on_row_share(q, k, v, share, causal, scale, q_offset)
        pl_q = dist.kernel_placements(mesh, B, (H,), 0, 2)
        pl_kv = dist.kernel_placements(mesh, B, (H, KVH), 0, 2)
        ql = dist.to_local_as(q, mesh, pl_q)
        if share is None or share.parts > 1 or pl_kv == pl_q:  # the KV heads replicated with the query heads, or sharded as they are
            kl, vl = (dist.to_local_as(x, mesh, pl_kv) for x in (k, v))
        else:
            (kl,), (vl,) = (_heads_of_rank(x, mesh, pl_kv, share.kv) for x in (k, v))
        out = dist.from_local(_Flash.apply(ql, kl, vl, causal, scale, q_offset), mesh, pl_q)
    else:
        out = _Flash.apply(q, k, v, causal, scale, q_offset)
    return out.reshape(B, S, H * D) if flat else out


def _heads_of_rank(x, mesh, placements, pick, rows: Tuple[slice, ...] = (slice(None),)) -> List[torch.Tensor]:
    """The heads ``pick`` of ``x`` (B, S, heads, D), replicated over
    ``model``, on each slice of ``rows`` of its sequence, as local tensors:
    the KV heads that this rank's query heads read, or its own query heads
    (both ``dist.row_split``). Their gradient, this rank's part, is a partial
    sum over ``model``."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, placements)]
    local = dist.to_local_as(x, mesh, placements, grad)
    if isinstance(pick, slice):
        return [local[:, r, pick].contiguous() for r in rows]
    index = torch.tensor(pick, device=local.device)
    return [local[:, r].index_select(2, index) for r in rows]


def _flash_on_row_share(q, k, v, share: "dist.RowShare", causal: bool, scale: float, q_offset: int):
    """``flash_attention`` on DTensors where ``model`` does not divide the
    query heads: each rank runs the kernel on its ``dist.row_split`` share,
    its group's query heads on its slices of the query rows (two under a
    causal mask, each a call with ``q_offset`` moved to its first row)
    against all the KV rows of the KV heads they read. dq, dk and dv come
    back as partial sums over ``model``, each rank's part of them in place
    (dk, dv summed over its calls). The outputs go to ``wo``'s row layout by
    one all-to-all over ``model`` (``RowsToWo``): the result is (B, S, H·D)
    with its columns sharded over ``model``."""
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    B, S, H, D = q.shape
    pl = dist.kernel_placements(mesh, B, (), 0, None)  # the batch over the data axes, the rest whole
    rows = share.rows(S, causal=causal)
    (kl,), (vl,) = (_heads_of_rank(x, mesh, pl, share.kv) for x in (k, v))
    qls = _heads_of_rank(q, mesh, pl, share.heads, rows)
    o = torch.cat([_Flash.apply(ql, kl, vl, causal, scale, q_offset + r.start) for ql, r in zip(qls, rows)], dim=1)
    exchange = RowsToWo(share, S, H, D, mesh.mesh.shape[mesh.mesh_dim_names.index(dist.TP_AXIS)], causal)
    out = _RowsToWo.apply(o, mesh.get_group(dist.TP_AXIS), exchange)
    return dist.from_local(out, mesh, [Shard(2) if name == dist.TP_AXIS else p
                                       for name, p in zip(mesh.mesh_dim_names, pl)])


@dataclasses.dataclass(frozen=True)
class RowsToWo:
    """The exchange that takes the row shares' output to ``wo``'s row layout:
    (B, S, H·D) with its columns in tp blocks of C = H·D/tp, block t on
    ``model`` rank t. A group's Hg·D columns are the blocks of its P ranks,
    so part p of a group sends each part p' of it its rows' columns of block
    p', and receives from each its rows of block p: B·S·C elements, 1/tp of
    the output. Pure functions of (share, S, H, D, tp) around the all-to-all
    (``_RowsToWo``): ``splits``, the elements sent to and received from each
    rank of ``model`` (zero outside the group; the backward swaps them),
    ``pack`` and ``unpack`` in the forward, ``pack_grad`` and ``unpack_grad``,
    its inverse, in the backward, each buffer in ``model``'s rank order.
    S >= parts: every part holds a row."""

    share: "dist.RowShare"
    S: int
    H: int
    D: int
    tp: int
    causal: bool

    def __post_init__(self):
        if self.H * self.D % self.tp:
            raise ValueError(f"wo's rows ({self.H} x {self.D}) do not divide over {self.tp} model ranks")

    @property
    def block(self) -> int:
        return self.H * self.D // self.tp

    def _rows(self, part: int) -> Tuple[slice, ...]:
        return self.share.rows(self.S, part, self.causal)

    def _n(self, part: int) -> int:
        return sum(r.stop - r.start for r in self._rows(part))

    def splits(self, batch: int) -> Tuple[List[int], List[int]]:
        """The forward's elements to and from each rank of ``model``, for
        ``batch`` local sequences: this rank's rows of each part's block to
        it, each part's rows of this rank's block from it."""
        share, C = self.share, self.block
        first = share.heads.start // (share.heads.stop - share.heads.start) * share.parts  # the group's first rank
        pad = [0] * first, [0] * (self.tp - first - share.parts)
        mine = batch * self._n(share.part) * C
        return ([*pad[0], *[mine] * share.parts, *pad[1]],
                [*pad[0], *(batch * self._n(p) * C for p in range(share.parts)), *pad[1]])

    def pack(self, o: torch.Tensor) -> torch.Tensor:
        """``o`` (B, R, Hg, D), this rank's output on its rows (in ``rows``
        order) -> column block p' of all its rows for each part p' in turn."""
        B, R = o.shape[:2]
        return o.reshape(B, R, self.share.parts, self.block).permute(2, 0, 1, 3).reshape(-1)

    def unpack(self, buf: torch.Tensor) -> torch.Tensor:
        """The group's parts' rows of this rank's block, one part after
        another -> (B, S, C), the block on every row."""
        C = self.block
        B = buf.numel() // (self.S * C)
        out, off = buf.new_empty(B, self.S, C), 0
        for p in range(self.share.parts):
            n = self._n(p)
            chunk, row = buf[off:off + B * n * C].view(B, n, C), 0
            for r in self._rows(p):
                out[:, r] = chunk[:, row:row + r.stop - r.start]
                row += r.stop - r.start
            off += B * n * C
        return out

    def pack_grad(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` (B, S, C), the gradient of this rank's block -> each part's
        rows of it in turn."""
        return torch.cat([torch.cat([g[:, r] for r in self._rows(p)], dim=1).reshape(-1)
                          for p in range(self.share.parts)])

    def unpack_grad(self, buf: torch.Tensor) -> torch.Tensor:
        """Each part's block of this rank's rows -> (B, R, Hg, D), the
        gradient of ``pack``'s input."""
        P, C, R = self.share.parts, self.block, self._n(self.share.part)
        B = buf.numel() // (P * R * C)
        return buf.view(P, B, R, C).permute(1, 2, 0, 3).reshape(B, R, P * C // self.D, self.D)


class _RowsToWo(torch.autograd.Function):
    """``RowsToWo`` over ``model``'s process group: one all-to-all in the
    forward, and its inverse on the gradient in the backward."""

    @staticmethod
    def forward(ctx, o, group, exchange: RowsToWo):
        from torch.distributed._functional_collectives import all_to_all_single

        ctx.group, ctx.exchange, ctx.batch = group, exchange, o.shape[0]
        to_each, from_each = exchange.splits(o.shape[0])
        return exchange.unpack(all_to_all_single(exchange.pack(o), from_each, to_each, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed._functional_collectives import all_to_all_single

        from_each, to_each = ctx.exchange.splits(ctx.batch)  # the forward's, swapped
        buf = all_to_all_single(ctx.exchange.pack_grad(g), from_each, to_each, ctx.group)
        return ctx.exchange.unpack_grad(buf), None, None


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
    (rows,) = share.rows(kl.shape[1])
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
