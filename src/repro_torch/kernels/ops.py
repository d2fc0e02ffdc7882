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
    it;
  * ``row_share_inputs`` and ``flash_on_row_share``, where ``model`` does not
    divide the query heads: each rank takes its ``dist.row_split`` share, a
    group of query heads on its part of the query rows (under a causal mask
    a zig-zag of two slices, which evens the live pairs; a call a slice,
    ``q_offset`` moved with it) and the KV heads they read. q's share comes
    from the projection's column blocks by one all-to-all inside the group
    (``RowShareExchange.to_rows``), the KV heads from the ranks whose blocks
    hold them by another (``KvToShare``), and the outputs go to ``wo``'s row
    layout by a third (``to_cols``): (B, S, H·D), its columns sharded, as q
    came. Nothing is gathered whole. Every exchange is differentiable, so
    ``_Flash`` runs unchanged between them;
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
    Returns o and, not differentiable, the log-sum-exp (B, KVH, S, G).

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
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)  # lse's gradient stays None: no zeros made for it
        return o, lse

    @staticmethod
    def backward(ctx, do, _lse_grad):
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
    """GQA flash attention with the model-API layout, (B, Sq, H, D) in and
    out. Differentiable. On DTensors each rank takes its batch and, where
    ``model`` divides them, its query heads; elsewhere the heads whole. The
    models reach a row share, whose output has no such view, through
    ``row_share_inputs`` and ``flash_on_row_share``, wherever each of a
    group's parts holds a row: the heads whole here are left to a sequence
    shorter than a group's parts."""
    B, _, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    if dist.is_dtensor(q):
        mesh = q.device_mesh
        KVH = k.shape[2]
        share = dist.row_split(mesh, H, KVH)
        pl_q = dist.kernel_placements(mesh, B, (H,), 0, 2)
        pl_kv = dist.kernel_placements(mesh, B, (H, KVH), 0, 2)
        ql = dist.to_local_as(q, mesh, pl_q)
        # the KV heads sharded as the query heads are, or replicated with them: where ``model``
        # divides neither (``share.parts > 1``) only a sequence shorter than the parts comes here
        if share is None or share.parts > 1 or pl_kv == pl_q:
            kl, vl = (dist.to_local_as(x, mesh, pl_kv) for x in (k, v))
        else:
            kl, vl = (_heads_of_rank(x, mesh, pl_kv, share.kv) for x in (k, v))
        return dist.from_local(_Flash.apply(ql, kl, vl, causal, scale, q_offset)[0], mesh, pl_q)
    return _Flash.apply(q, k, v, causal, scale, q_offset)[0]


def _heads_of_rank(x, mesh, placements, pick) -> torch.Tensor:
    """The KV heads ``pick`` of ``x`` (B, S, KVH, D), replicated over
    ``model``, that this rank's query heads read (``dist.row_split`` where
    ``model`` divides the query heads), as a local tensor. Its gradient, this
    rank's part, is a partial sum over ``model``."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, placements)]
    local = dist.to_local_as(x, mesh, placements, grad)
    if isinstance(pick, slice):
        return local[:, :, pick].contiguous()
    return local.index_select(2, torch.tensor(pick, device=local.device))


# ---------------------------------------------------------------------------
# the row shares: where ``model`` does not divide the query heads
# ---------------------------------------------------------------------------


def _cols_placements(mesh, batch: int) -> list:
    """The layout of a projection's output (B, S, heads·D) around a row
    share: the batch over the data axes (``kernel_placements``), the columns
    in blocks over ``model``."""
    from torch.distributed.tensor import Shard

    return [Shard(2) if name == dist.TP_AXIS else pl
            for name, pl in zip(mesh.mesh_dim_names, dist.kernel_placements(mesh, batch, (), 0, None))]


@dataclasses.dataclass(frozen=True)
class RowShareInputs:
    """A row share's operands, local to its rank (``row_share_inputs``): ``q``
    (B, R, Hg, D) its group's query heads on its rows (``rows``, in order),
    ``k`` and ``v`` (B, Skv, n, D) the n KV heads ``share.kv`` spans on every
    KV row; the column layout they came from and go back to (``placements``
    on ``mesh``), and the exchange that sends the output there."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    share: "dist.RowShare"
    rows: Tuple[slice, ...]
    exchange: "RowShareExchange"
    mesh: object
    placements: list

    @property
    def causal(self) -> bool:
        return self.exchange.causal


def row_share_inputs(q, k, v, share: "dist.RowShare", kv_heads: int, head_dim: int, causal: bool) -> RowShareInputs:
    """``share``'s operands from the projections' outputs q (B, Sq, H·D) and
    k, v (B, Skv, KVH·D), DTensors whose columns lie in blocks over
    ``model`` as the column-parallel products leave them: q's share by one
    all-to-all inside the group (``RowShareExchange.to_rows``), the KV heads
    it reads from the ranks whose blocks hold them (``KvToShare``), k and v
    in one all-to-all. Nothing is gathered whole; the gradients go back to
    the column blocks the same ways, dk and dv summed by their owners."""
    mesh = q.device_mesh
    B, S, HD = q.shape
    tp = dist.tp_size(mesh)
    group, rank = mesh.get_group(dist.TP_AXIS), mesh.get_local_rank(dist.TP_AXIS)
    cols = _cols_placements(mesh, B)
    exchange = RowShareExchange(share, S, HD // head_dim, head_dim, tp, causal)
    ql = _ColsToRows.apply(dist.to_local_as(q, mesh, cols), group, exchange)
    kv = torch.cat([dist.to_local_as(x, mesh, cols) for x in (k, v)])  # (2B, Skv, C): one exchange for both
    both = _KvToShare.apply(kv, group, KvToShare(HD // head_dim, kv_heads, head_dim, tp, rank))
    kl, vl = both.unflatten(-1, (-1, head_dim)).chunk(2)
    return RowShareInputs(ql, kl, vl, share, share.rows(S, causal=causal), exchange, mesh, cols)


def flash_on_share(q, k, v, share: "dist.RowShare", rows: Tuple[slice, ...],
                   causal: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The flash kernel on a row share's local operands, no collective: ``q``
    (B, R, Hg, D) the share's query heads on ``rows`` (in order), ``k`` and
    ``v`` (B, Skv, n, D) the KV heads ``share.kv_span`` spans on every KV
    row. A call a slice of the rows (two under a causal mask, the zig-zag),
    ``q_offset`` the slice's first row, against the KV heads its query heads
    read (a list ``share.kv`` picked from the span, repeated where two read
    one). dk and dv sum over the calls. Returns o (B, R, Hg, D) and each
    call's log-sum-exp (B, KV heads read, rows, G)."""
    if not isinstance(share.kv, slice):  # a KV head a query head, repeated where two read one
        first = share.kv_span()[0]
        index = torch.tensor([h - first for h in share.kv], device=k.device)
        k, v = k.index_select(2, index), v.index_select(2, index)
    o, lse, row = [], [], 0
    for r in rows:
        n = r.stop - r.start
        o_r, lse_r = _Flash.apply(q[:, row:row + n], k, v, causal, q.shape[-1]**-0.5, r.start)
        o.append(o_r)
        lse.append(lse_r)
        row += n
    return torch.cat(o, dim=1), lse


def flash_on_row_share(ins: RowShareInputs) -> torch.Tensor:
    """The flash kernel on a rank's row share (``row_share_inputs``) by
    ``flash_on_share``. The output goes to ``wo``'s row layout by one
    all-to-all over ``model`` (``RowShareExchange.to_cols``): (B, S, H·D)
    with its columns sharded over ``model``, as the projections left q."""
    o, _ = flash_on_share(ins.q, ins.k, ins.v, ins.share, ins.rows, ins.causal)
    out = _RowsToCols.apply(o, ins.mesh.get_group(dist.TP_AXIS), ins.exchange)
    return dist.from_local(out, ins.mesh, ins.placements)


def write_row_share_cache(ins: RowShareInputs, k_cache, v_cache) -> None:
    """Prefill's cache writes from a row share: ``k_cache`` and ``v_cache``
    (B, S, KVH, D) take all S rows of the share's (RoPE'd) ``k`` and ``v``.
    Each rank's own column block of them reaches the cache rows of every
    rank by one all-to-all over ``model``, the ``to_rows`` of a share of all
    KV heads (1/tp of K and V a rank), where the cache lies in its rows over
    ``model`` (the reference's spec: the sequence over ``model``). A layout
    that holds the rows whole on ``model`` (whisper-base's cross cache of
    1500 frames) gathers the blocks: that gather is the cache's own."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ins.mesh
    B, S, _, D = ins.k.shape
    KVH = k_cache.shape[2]
    own, exchange = cache_exchange(ins.k, ins.v, ins.share, KVH, ins.exchange.tp, mesh.get_local_rank(dist.TP_AXIS))
    by_rows = [Shard(1) if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, ins.placements)]
    if list(k_cache.placements) == by_rows and k_cache.shape[1] == S and S % exchange.tp == 0:
        from torch.distributed._functional_collectives import all_to_all_single

        to_each, from_each = exchange.splits(2 * B, to_rows=True)
        rows = exchange.unpack_rows(all_to_all_single(exchange.pack_cols(own), from_each, to_each,
                                                      mesh.get_group(dist.TP_AXIS)))
        k_cache.to_local().copy_(rows[:B])
        v_cache.to_local().copy_(rows[B:])
        return
    whole = [Replicate() if name == dist.TP_AXIS else pl for name, pl in zip(mesh.mesh_dim_names, ins.placements)]
    for x, dst in zip(own.chunk(2), (k_cache, v_cache)):
        src = dist.from_local(x, mesh, ins.placements).redistribute(mesh, whole)
        dist.write_rows(dst, 1, 0, src.view(*src.shape[:2], KVH, D))


def cache_exchange(k, v, share: "dist.RowShare", kv_heads: int, tp: int,
                   t: int) -> Tuple[torch.Tensor, "RowShareExchange"]:
    """The local half of ``write_row_share_cache`` on rank ``t`` of
    ``model``, no collective: rank t's own column block of the share's k and
    v (B, S, n, D), stacked (2B, S, KVH·D/tp), and the exchange that takes
    every rank's block to rank t's cache rows, the ``to_rows`` of a share of
    all ``kv_heads`` over ``tp`` parts."""
    _, S, _, D = k.shape
    C, c0 = kv_heads * D // tp, share.kv_span()[0] * D
    own = torch.cat([x.flatten(2)[..., t * C - c0:(t + 1) * C - c0] for x in (k, v)])
    every = dist.RowShare(slice(0, kv_heads), slice(0, kv_heads), t, tp)
    return own, RowShareExchange(every, S, kv_heads, D, tp, False)


@dataclasses.dataclass(frozen=True)
class RowShareExchange:
    """The exchange between a row share's layout and the column blocks of
    ``model``: (B, S, H·D) with its columns in tp blocks of C = H·D/tp, block
    t on ``model`` rank t. A group's Hg·D columns are the blocks of its P
    ranks, so each direction is one all-to-all inside the group, of B·S·C
    elements a rank, 1/tp of the tensor:

      * ``to_cols``: the shares' output (B, R, Hg, D) to ``wo``'s input
        block (B, S, C). Part p of a group sends each part p' its rows'
        columns of block p' (``pack_rows``) and takes from each its rows of
        block p (``unpack_cols``). q's gradient goes this way;
      * ``to_rows``, its inverse: a projection's column block (B, S, C) to
        the share's (B, R, Hg, D) (``pack_cols``, ``unpack_rows``): q's way,
        and the way of the output's gradient; with a share of every head
        over all tp parts, the way of prefill's K/V to the cache's rows.

    Pure functions of (share, S, H, D, tp, causal) around the all-to-alls
    (``_RowsToCols``, ``_ColsToRows``); ``splits`` the elements to and from
    each rank of ``model`` (zero outside the group), each buffer in
    ``model``'s rank order. S >= parts: every part holds a row."""

    share: "dist.RowShare"
    S: int
    H: int
    D: int
    tp: int
    causal: bool

    def __post_init__(self):
        if self.H * self.D % self.tp:
            raise ValueError(f"the columns ({self.H} x {self.D}) do not divide over {self.tp} model ranks")

    @property
    def block(self) -> int:
        return self.H * self.D // self.tp

    def _rows(self, part: int) -> Tuple[slice, ...]:
        return self.share.rows(self.S, part, self.causal)

    def _n(self, part: int) -> int:
        return sum(r.stop - r.start for r in self._rows(part))

    def splits(self, batch: int, to_rows: bool = False) -> Tuple[List[int], List[int]]:
        """The elements this rank sends to and receives from each rank of
        ``model`` for ``batch`` local sequences: ``to_cols`` its rows of
        each part's block to it, each part's rows of this rank's block from
        it; ``to_rows`` the reverse."""
        share, C = self.share, self.block
        first = share.heads.start // (share.heads.stop - share.heads.start) * share.parts  # the group's first rank
        pad = [0] * first, [0] * (self.tp - first - share.parts)
        mine = [*pad[0], *[batch * self._n(share.part) * C] * share.parts, *pad[1]]
        theirs = [*pad[0], *(batch * self._n(p) * C for p in range(share.parts)), *pad[1]]
        return (theirs, mine) if to_rows else (mine, theirs)

    def pack_rows(self, o: torch.Tensor) -> torch.Tensor:
        """``o`` (B, R, Hg, D), a share on its rows (in ``rows`` order) ->
        column block p' of all its rows for each part p' in turn."""
        B, R = o.shape[:2]
        return o.reshape(B, R, self.share.parts, self.block).permute(2, 0, 1, 3).reshape(-1)

    def unpack_cols(self, buf: torch.Tensor) -> torch.Tensor:
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

    def pack_cols(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, S, C), this rank's column block -> each part's rows of
        it in turn."""
        return torch.cat([torch.cat([x[:, r] for r in self._rows(p)], dim=1).reshape(-1)
                          for p in range(self.share.parts)])

    def unpack_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """Each part's block of this rank's rows -> (B, R, Hg, D), the
        share."""
        P, C, R = self.share.parts, self.block, self._n(self.share.part)
        B = buf.numel() // (P * R * C)
        return buf.view(P, B, R, C).permute(1, 2, 0, 3).reshape(B, R, P * C // self.D, self.D)


class _RowsToCols(torch.autograd.Function):
    """``RowShareExchange.to_cols`` over ``model``'s process group: one
    all-to-all in the forward, ``to_rows`` on the gradient."""

    @staticmethod
    def forward(ctx, o, group, exchange: RowShareExchange):
        ctx.group, ctx.exchange, ctx.batch = group, exchange, o.shape[0]
        return _exchange(exchange, o.shape[0], group, False, o)

    @staticmethod
    def backward(ctx, g):
        return _exchange(ctx.exchange, ctx.batch, ctx.group, True, g), None, None


class _ColsToRows(torch.autograd.Function):
    """``RowShareExchange.to_rows`` over ``model``'s process group, the
    mirror of ``_RowsToCols``: q's way to a share, its gradient back to the
    column block by ``to_cols`` (no reduction: each element has one owner)."""

    @staticmethod
    def forward(ctx, x, group, exchange: RowShareExchange):
        ctx.group, ctx.exchange, ctx.batch = group, exchange, x.shape[0]
        return _exchange(exchange, x.shape[0], group, True, x)

    @staticmethod
    def backward(ctx, g):
        return _exchange(ctx.exchange, ctx.batch, ctx.group, False, g), None, None


def _exchange(exchange: RowShareExchange, batch: int, group, to_rows: bool, x: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import all_to_all_single

    to_each, from_each = exchange.splits(batch, to_rows)
    pack, unpack = (exchange.pack_cols, exchange.unpack_rows) if to_rows else (exchange.pack_rows,
                                                                               exchange.unpack_cols)
    return unpack(all_to_all_single(pack(x.contiguous()), from_each, to_each, group))


@dataclasses.dataclass(frozen=True)
class KvToShare:
    """The exchange that brings rank ``rank`` of ``model`` the K/V columns its
    row share reads (``RowShare.kv_span``, every KV row) from the ranks whose
    blocks hold them: k and v leave their products as (N, S, KVH·D) with the
    columns in tp blocks of C = KVH·D/tp, and rank t sends rank r the
    columns of its block that r reads. A group's KV heads span its own
    ranks' blocks, so where the group holds whole KV groups (every registry
    arch at ``model`` 16) this is a gather inside the group; a group inside
    one KV group (``_kv_heads_read``'s second case) reads from the ranks
    that hold that head, in or out of the group. The backward sends each
    rank's gradient of those columns back to their owners, which sum what
    they get. Pure functions of (heads, kv_heads, D, tp, rank) around the
    all-to-all (``_KvToShare``); ``splits`` in elements, zero to and from a
    rank that holds none of the columns the other reads."""

    heads: int
    kv_heads: int
    D: int
    tp: int
    rank: int

    def __post_init__(self):
        if self.kv_heads * self.D % self.tp:
            raise ValueError(f"the KV columns ({self.kv_heads} x {self.D}) do not divide over {self.tp} model ranks")

    @property
    def block(self) -> int:
        return self.kv_heads * self.D // self.tp

    def cols(self, reader: int) -> Tuple[int, int]:
        """The columns [c0, c1) that rank ``reader``'s share reads."""
        lo, hi = dist.share_of(reader, self.heads, self.kv_heads, self.tp).kv_span()
        return lo * self.D, hi * self.D

    def _piece(self, owner: int, reader: int) -> Tuple[int, int]:
        """The columns of ``owner``'s block that ``reader`` reads; empty where hi <= lo."""
        c0, c1 = self.cols(reader)
        return max(c0, owner * self.block), min(c1, (owner + 1) * self.block)

    def _width(self, owner: int, reader: int) -> int:
        lo, hi = self._piece(owner, reader)
        return max(0, hi - lo)

    def splits(self, n: int) -> Tuple[List[int], List[int]]:
        """The elements this rank sends to and receives from each rank of
        ``model``, ``n`` elements a column (the local sequences x KV rows)."""
        return ([n * self._width(self.rank, r) for r in range(self.tp)],
                [n * self._width(t, self.rank) for t in range(self.tp)])

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (N, S, C), this rank's block -> each reader's columns of it
        in rank order."""
        base = self.rank * self.block
        return torch.cat([x[..., lo - base:hi - base].reshape(-1)
                          for lo, hi in (self._piece(self.rank, r) for r in range(self.tp)) if hi > lo])

    def unpack(self, buf: torch.Tensor, N: int, S: int) -> torch.Tensor:
        """Each owner's columns, in rank order -> (N, S, c1 - c0), the
        columns this rank reads."""
        chunks, off = [], 0
        for t in range(self.tp):
            w = self._width(t, self.rank)
            if w:
                chunks.append(buf[off:off + N * S * w].view(N, S, w))
                off += N * S * w
        return torch.cat(chunks, dim=-1)

    def pack_grad(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` (N, S, c1 - c0), the gradient of what this rank read ->
        each owner's columns of it, in rank order."""
        c0 = self.cols(self.rank)[0]
        return torch.cat([g[..., lo - c0:hi - c0].reshape(-1)
                          for lo, hi in (self._piece(t, self.rank) for t in range(self.tp)) if hi > lo])

    def unpack_grad(self, buf: torch.Tensor, N: int, S: int) -> torch.Tensor:
        """Each reader's gradient of this rank's columns, in rank order ->
        (N, S, C), their sum: the gradient of this rank's block."""
        base, out, off = self.rank * self.block, buf.new_zeros(N, S, self.block), 0
        for r in range(self.tp):
            lo, hi = self._piece(self.rank, r)
            if hi > lo:
                out[..., lo - base:hi - base] += buf[off:off + N * S * (hi - lo)].view(N, S, hi - lo)
                off += N * S * (hi - lo)
        return out


class _KvToShare(torch.autograd.Function):
    """``KvToShare`` over ``model``'s process group: one all-to-all each way."""

    @staticmethod
    def forward(ctx, x, group, exchange: KvToShare):
        from torch.distributed._functional_collectives import all_to_all_single

        N, S = x.shape[:2]
        ctx.group, ctx.exchange, ctx.shape = group, exchange, (N, S)
        to_each, from_each = exchange.splits(N * S)
        return exchange.unpack(all_to_all_single(exchange.pack(x.contiguous()), from_each, to_each, group), N, S)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed._functional_collectives import all_to_all_single

        N, S = ctx.shape
        to_each, from_each = ctx.exchange.splits(N * S)  # the forward's: this rank now sends what it received
        buf = all_to_all_single(ctx.exchange.pack_grad(g.contiguous()), to_each, from_each, ctx.group)
        return ctx.exchange.unpack_grad(buf, N, S), None, None


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
