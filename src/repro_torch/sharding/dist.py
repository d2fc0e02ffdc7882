"""DTensor helpers of the multi-device path.

The sharded steps keep parameters, optimizer moments, batches and caches as
``torch.distributed.tensor.DTensor``s on a ``DeviceMesh``: the twin of the
reference's global arrays with a ``NamedSharding``. Everything here is the
identity on a plain tensor, so the single-device path runs the same code.
``torch.distributed.tensor`` is imported inside the functions: importing this
module starts nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """The local shard of a DTensor (a view of its storage), or ``x``."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The whole tensor on every rank (differentiable), or ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def implicit_replication():
    """A block in which a plain tensor meeting a DTensor counts as replicated:
    the constants a model makes on its own (positions, masks, rotary tables)."""
    from torch.distributed.tensor.experimental import implicit_replication as ctx

    return ctx()


def distribute(tree: Any, shardings: Any) -> Any:
    """``tree``'s tensors as DTensors with the placements of ``shardings``
    (a matching tree of ``plan.NamedSharding``), the twin of ``device_put``.
    Every rank passes the same whole tensors; a 0-d leaf stays a plain tensor
    (every rank holds it, as a replicated scalar)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [distribute(v, s) for v, s in zip(tree, shardings)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    if tree.dim() == 0:
        return tree
    from torch.distributed.tensor import distribute_tensor

    mesh = shardings.mesh
    device = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" else \
        torch.device("cpu")
    tree = tree.to(device)
    if mesh.size() == 1:  # the whole tensor is the one shard: no copy
        return from_local(tree.contiguous(), mesh, shardings.placements)
    return distribute_tensor(tree, mesh, shardings.placements)


def replicated(x):
    """``x`` whole on every rank, still a DTensor (``Replicate`` on every mesh
    dim), or ``x``: for the ops whose DTensor rule fails on our layouts
    (ROADMAP.md lists them)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


def _whole_partials(x):
    from torch.distributed.tensor import Replicate

    want = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


class _Reduced(torch.autograd.Function):
    """Partial placements reduced to ``Replicate``, and in backward the
    gradient's partial placements too (a ``Partial(sum)`` gradient of a
    ``Partial(avg)`` value, which DTensor's own backward cannot convert)."""

    @staticmethod
    def forward(ctx, x):
        return _whole_partials(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_partials(g)


def reduced(x):
    """``x`` with each partial placement reduced to ``Replicate`` (its other
    placements kept), or ``x``: a statistic over a sharded dim (a norm's
    mean), made whole before it meets the shards. Left partial, DTensor
    brings the shards to the statistic's ``Partial(avg)`` instead, which
    gathers them and carries the partial type on to the next product, whose
    ``Partial(sum)`` gradient DTensor then cannot convert back."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    return _Reduced.apply(x)


def whole_on(x, dim: int):
    """``x`` with dim ``dim`` unsharded (its other placements kept), or ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.dim()
    want = [Replicate() if pl.is_shard(dim) else pl for pl in x.placements]
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


def split_heads(x, heads: int, head_dim: int):
    """(..., heads * head_dim) -> (..., heads, head_dim). A DTensor whose last
    dim is sharded over more pieces than ``heads`` divides into is gathered
    on that dim first: DTensor cannot view it (GSPMD moves it on its own)."""
    if is_dtensor(x):
        n = math.prod(size for pl, size in zip(x.placements, x.device_mesh.mesh.shape) if pl.is_shard(x.dim() - 1))
        if heads % n:
            x = whole_on(x, -1)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def rows_flattenable(x):
    """``x`` with the dims between its first and its last unsharded: a matmul
    flattens them with the first, and DTensor (torch 2.11) refuses to flatten
    a sharded inner dim without redistributing. Under ``sp`` this gathers the
    sequence before each projection, as Megatron's sequence parallelism does."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate

    want = [Replicate() if pl.is_shard() and 0 < pl.dim < x.dim() - 1 else pl for pl in x.placements]
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


def split_as_rows_of(x, w):
    """``x`` (..., in) with its last dim sharded on each mesh dim on which
    ``w`` (in, out) shards its rows and ``x`` is whole, or ``x``: the input of
    a row-parallel product, sliced where it lies and in sight of autograd.
    DTensor slices it inside the product's dispatch, where autograd does not
    see it, so the product's backward would compute the weight's gradient
    from the whole input on every rank of the axis (whisper's ``wo``, whose
    input the attention gathers whole)."""
    if not (is_dtensor(x) and is_dtensor(w)) or w.dim() < 2:
        return x
    from torch.distributed.tensor import Shard

    want = [Shard(x.dim() - 1) if wp.is_shard(w.dim() - 2) and xp.is_replicate() and size > 1 else xp
            for xp, wp, size in zip(x.placements, w.placements, x.device_mesh.mesh.shape)]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


class _GradAs(torch.autograd.Function):
    """The identity; in backward the gradient is brought to the placements
    the forward value had, a partial sum made whole, or kept partial where
    the gradient is and ``keep_partial`` says so."""

    @staticmethod
    def forward(ctx, x, keep_partial: bool):
        from torch.distributed.tensor import Replicate

        ctx.mesh, ctx.keep_partial = x.device_mesh, keep_partial
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = tuple(gp if ctx.keep_partial and gp.is_partial() else fp
                     for gp, fp in zip(g.placements, ctx.placements))
        return (g if tuple(g.placements) == want else g.redistribute(ctx.mesh, want)), None


def grad_as(x, keep_partial: bool = False):
    """``x`` (a product's input or output), whose gradient will come back in
    ``x``'s placements, a ``Partial`` one as ``Replicate``; or ``x``, where it
    is no DTensor in autograd. An op that meets two layouts redistributes one
    operand inside its dispatch, where autograd does not see it, so the
    gradient reaches the product in the op's layout: a sequence-sharded one,
    which the product's backward cannot flatten into its rows (torch 2.11),
    or a partial sum, on which DTensor runs the product's backward by
    gathering the weight whole, repeating it on every rank of the axis. Here
    the partial sum is reduced once (Megatron's all-reduce in backward).
    ``keep_partial`` leaves a partial gradient partial (a product's input:
    the partial sums of the products that read it add up before one
    reduction)."""
    if not is_dtensor(x) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradAs.apply(x, keep_partial)


def like(g, p):
    """``g`` (a gradient) in ``p``'s placements, where ``p`` is a DTensor."""
    if not is_dtensor(p):
        return g
    if list(g.placements) != list(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def owned_sum(parts) -> torch.Tensor:
    """The sum over ranks of ``parts`` — (tensor, DTensor or None) pairs: each
    tensor a sum this rank took over its local shard of the DTensor (or over a
    plain tensor, which is the whole). A shard that the mesh replicates over
    some dims is counted on the ranks at coordinate 0 of those dims only, so
    that each element of each global tensor is counted once. One all-reduce
    for all of them where any is a DTensor."""
    total = None
    mesh = None
    for value, ref in parts:
        if ref is not None and is_dtensor(ref):
            mesh = ref.device_mesh
            coord = mesh.get_coordinate()
            if any(not pl.is_shard() and c != 0 for pl, c in zip(ref.placements, coord)):
                value = torch.zeros_like(value)
        total = value if total is None else total + value
    return total if mesh is None else all_sum(total, mesh)


def all_sum(x: torch.Tensor, mesh, dims: Optional[Sequence[int]] = None, op: str = "sum") -> torch.Tensor:
    """The sum (or, with ``op="max"``, the maximum) of ``x`` over the ranks of
    ``mesh``'s dims ``dims`` (all of them by default): a new tensor, one
    all-reduce a mesh dim. Not differentiable (``sum_over`` is)."""
    import torch.distributed as tdist

    reduce_op = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    x = x.clone()
    for d in range(mesh.ndim) if dims is None else dims:
        tdist.all_reduce(x, op=reduce_op, group=mesh.get_group(d))
    return x


class _SumOver(torch.autograd.Function):
    """The sum of a local tensor over the ranks of some mesh dims; in backward
    the identity: every rank goes on with the same sum (a replicated value),
    so the gradient of each rank's part is the sum's gradient, as Megatron's
    vocab-parallel loss takes it."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return all_sum(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``all_sum(x, mesh, dims)``, differentiable (``_SumOver``); ``x`` where
    ``dims`` is empty."""
    return _SumOver.apply(x, mesh, tuple(dims)) if dims else x


def batch_sum_over(mesh, axes):
    """A differentiable sum over the ranks of ``mesh``'s dims ``axes`` (the
    ranks that split a batch): ``ShardingPlan.batch_sum`` of the zero step."""
    from torch.distributed.nn.functional import all_reduce

    groups = [mesh.get_group(a) for a in axes]

    def batch_sum(t: torch.Tensor) -> torch.Tensor:
        for g in groups:
            t = all_reduce(t, group=g)
        return t

    return batch_sum


# ---------------------------------------------------------------------------
# the kernels' boundary: a layout in which each rank's work is whole
# ---------------------------------------------------------------------------

DP_AXES = ("pod", "data")
TP_AXIS = "model"


def kernel_placements(mesh, batch: int, heads: Sequence[int], batch_dim: Optional[int],
                      head_dim: Optional[int]) -> list:
    """Placements under which a kernel's work is local: the batch (tensor dim
    ``batch_dim``; None for a tensor without one) over the data axes when
    they divide it, heads (dim ``head_dim``; None for a tensor without one)
    over ``model`` when it divides every head count given, everything else
    replicated. With no head dim these are the placements in which each rank
    holds whole examples. An attention gives its query heads alone: its KV
    heads follow them (``row_split``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.mesh.shape))
    dp = [a for a in names if a in DP_AXES]
    dp_ok = batch % math.prod(sizes[a] for a in dp) == 0
    tp_ok = TP_AXIS in sizes and all(h % sizes[TP_AXIS] == 0 for h in heads)
    out = []
    for name in names:
        if name in dp and dp_ok and batch_dim is not None:
            out.append(Shard(batch_dim))
        elif name == TP_AXIS and tp_ok and head_dim is not None:
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


def tp_size(mesh) -> int:
    """The ranks of ``mesh``'s ``model`` axis (1 without one), read from its
    layout: unlike ``mesh.mesh``, which a ``DeviceMesh`` builds from its rank
    map by tensor ops that the op counters see, it dispatches nothing."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(TP_AXIS)) if TP_AXIS in names else 1


def _kv_heads_read(h0: int, local: int, group: int):
    """The KV heads that query heads [h0, h0 + local) read, query head h
    reading KV head h // ``group`` (G), as an index into the KV head dim of
    whole KV heads:

      * a slice of local/G KV heads where the heads are whole groups (the
        local group size stays G; every case where ``model`` divides the KV
        heads too);
      * a slice of one KV head where they lie inside one group (local group
        size ``local``: 2 for the 32/8-head archs at ``model`` 16, 4 for
        qwen2, 7 for llava-next-34b);
      * a list of one KV head a query head where they span groups unevenly
        (local group size 1: right, not faster; e.g. H 12, KVH 4 at
        ``model`` 6; no registry arch at ``model`` 16).
    """
    if local % group == 0:
        return slice(h0 // group, (h0 + local) // group)
    if group % local == 0:
        return slice(h0 // group, h0 // group + 1)
    return [h // group for h in range(h0, h0 + local)]


@dataclasses.dataclass(frozen=True)
class RowShare:
    """One ``model`` rank's share of an attention (``row_split``): the query
    heads ``heads``, the KV heads ``kv`` they read (``_kv_heads_read``), and
    part ``part`` of ``parts`` of the rows (the query rows of a flash
    attention, the cache rows of a decode; ``rows``). ``parts`` is 1 where
    ``model`` divides the query heads: the rank's heads on every row."""

    heads: slice
    kv: Any
    part: int
    parts: int

    def kv_span(self) -> Tuple[int, int]:
        """The KV heads ``kv`` names, as one range [lo, hi): a list's are
        consecutive, one or more a KV head."""
        if isinstance(self.kv, slice):
            return self.kv.start, self.kv.stop
        return self.kv[0], self.kv[-1] + 1

    def rows(self, n: int, part: Optional[int] = None, causal: bool = False) -> Tuple[slice, ...]:
        """The slices of ``n`` rows that part ``part`` (default this rank's)
        holds, in order. Contiguous, rows [part·n // parts, (part+1)·n //
        parts), where the work is even by rows: a decode's cache rows, a
        non-causal attention's query rows, and a causal attention's where
        ``n < 2·parts``. A causal attention's longer query rows are cut into
        2·parts slices (slice j rows [j·n // 2P, (j+1)·n // 2P)) and part p
        takes slices p and 2·parts − 1 − p, a zig-zag: query row r sees r + 1
        keys, so slice j of m rows holds (2j + 1)·m²/2 + m/2 live pairs, and
        where 2·parts divides n each part (2p + 1) + (4·parts − 2p − 1) =
        4·parts halves of m², plus m; elsewhere the parts differ by at most
        one row's."""
        part = self.part if part is None else part
        if not causal or self.parts == 1 or n < 2 * self.parts:
            return (slice(part * n // self.parts, (part + 1) * n // self.parts),)
        cut = 2 * self.parts
        return tuple(slice(j * n // cut, (j + 1) * n // cut) for j in (part, cut - 1 - part))


def row_split(mesh, heads: int, kv_heads: int) -> Optional[RowShare]:
    """This rank's ``RowShare`` of an attention where ``model`` has more than
    one rank (None elsewhere). ``model``'s tp ranks form g = gcd(heads, tp)
    groups of tp/g consecutive ranks; group i holds the contiguous query
    heads [i·heads/g, (i+1)·heads/g) and each of its ranks one of tp/g parts
    of the rows (``RowShare.rows``). Where ``model`` divides the heads that
    is one part: rank r holds heads [r·heads/tp, (r+1)·heads/tp) on every
    row, which ``kernel_placements`` shards. Elsewhere each rank computes
    1/tp of the attention's FLOPs: whisper-base's 8 heads at ``model`` 16
    are 8 groups of one head, each split over 2 ranks; llava-next-34b's 56
    (G 7) are 8 groups of 7 heads, one KV head each. Under a causal mask a
    group's parts take a zig-zag of the query rows, so that each holds the
    same live query x key pairs as the others: a contiguous slice would give
    the second of two 3x the first's."""
    names = mesh.mesh_dim_names or ()
    # ``mesh.mesh`` as the other helpers here read it, not ``tp_size``: its ops reach the op
    # counters, and every step's fingerprint holds them
    tp = mesh.mesh.shape[names.index(TP_AXIS)] if TP_AXIS in names else 1
    if tp <= 1:
        return None
    return share_of(mesh.get_local_rank(TP_AXIS), heads, kv_heads, tp)


def share_of(t: int, heads: int, kv_heads: int, tp: int) -> RowShare:
    """The ``RowShare`` of rank ``t`` of ``model``'s ``tp`` ranks
    (``row_split``): what every rank knows of every other's, to size an
    exchange between them."""
    groups = math.gcd(heads, tp)
    parts, local = tp // groups, heads // groups
    h0 = t // parts * local
    return RowShare(slice(h0, h0 + local), _kv_heads_read(h0, local, heads // kv_heads), t % parts, parts)


def coordinate_on(mesh, dims: Sequence[int]) -> tuple:
    """``(part, parts)``: this rank's index among the ranks of ``mesh``'s dims
    ``dims`` (its coordinates read in mesh order, the first the slowest) and
    their number."""
    part, parts = 0, 1
    for d in dims:
        size = mesh.mesh.shape[d]
        part, parts = part * size + mesh.get_coordinate()[d], parts * size
    return part, parts


def shard_rows(x, dim: int, placements=None):
    """``(first row, rows)`` of ``x``'s local shard on ``dim`` (in
    ``placements``, default its own): the mesh dims that shard ``dim`` split
    it in mesh order, as DTensor lays even shards out; ``(0, x.shape[dim])``
    for a plain tensor."""
    dim %= x.dim()
    rows, offset = x.shape[dim], 0
    if not is_dtensor(x):
        return offset, rows
    mesh = x.device_mesh
    for pl, size, c in zip(x.placements if placements is None else placements, mesh.mesh.shape,
                           mesh.get_coordinate()):
        if pl.is_shard(dim):
            if rows % size:
                raise ValueError(f"uneven shards: {rows} rows over {size}")
            rows //= size
            offset += c * rows
    return offset, rows


def sharded_on(x, dim: int) -> list:
    """The mesh dims of more than one rank that shard tensor dim ``dim`` of
    ``x`` (none for a plain tensor): a dim of one rank holds it whole."""
    if not is_dtensor(x):
        return []
    sizes = x.device_mesh.mesh.shape
    return [i for i, pl in enumerate(x.placements) if pl.is_shard(dim % x.dim()) and sizes[i] > 1]


def to_local_as(x, mesh, placements, grad_placements=None) -> torch.Tensor:
    """``x`` (a DTensor, or a plain tensor every rank holds whole)
    redistributed to ``placements``, as its local shard; its gradient comes
    back in ``grad_placements`` (default: ``placements``)."""
    if not is_dtensor(x):
        from torch.distributed.tensor import Replicate

        x = from_local(x, mesh, [Replicate()] * mesh.ndim)
    if list(x.placements) != list(placements):
        x = x.redistribute(mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def lookup(table, ids) -> torch.Tensor:
    """``F.embedding(ids, table)``. Where ``table`` is a DTensor whose rows
    (the vocab) are sharded on mesh dims over which ``ids`` are replicated
    (the reference's plan: the table over ``model``), each rank looks up in
    its own rows, ids outside them giving zeros, and the parts are summed
    over those dims; the table's other dims are gathered first. No rank holds
    the table whole. Elsewhere the table is gathered whole."""
    import torch.nn.functional as F

    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = from_local(ids, mesh, [Replicate()] * mesh.ndim)
    vocab = [tp.is_shard(0) and ip.is_replicate() and size > 1
             for tp, ip, size in zip(table.placements, ids.placements, mesh.mesh.shape)]
    if not any(vocab):
        return F.embedding(ids, replicated(table))
    want = [Shard(0) if v else Replicate() for v in vocab]
    # the rows' gradient: each rank's own rows, summed over the ranks that split the ids
    grad = [Shard(0) if v else (Partial() if ip.is_shard() else Replicate()) for v, ip in zip(vocab, ids.placements)]
    rows = to_local_as(table, mesh, want, grad)
    v0 = shard_rows(table, 0, want)[0]
    il = ids.to_local()
    inside = (il >= v0) & (il < v0 + rows.shape[0])
    out = F.embedding(torch.where(inside, il - v0, 0), rows) * inside[..., None].to(rows.dtype)
    parts = [Partial() if v else ip for v, ip in zip(vocab, ids.placements)]
    return reduced(from_local(out, mesh, parts, (*ids.shape, table.shape[1])))


def local_operand(w, like, dims: dict) -> torch.Tensor:
    """The local shard of ``w`` (a DTensor) for a computation each rank runs
    on its own part of ``like`` (a DTensor): on each mesh dim on which
    ``like`` is sharded on a tensor dim ``d`` of ``dims``, ``w`` is sharded on
    its dim ``dims[d]`` the same way; on the others it is whole. In backward
    the ranks' local gradients are summed over the mesh dims on which
    ``like`` is split on a dim ``w`` lacks (its examples), as FSDP sums them."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not is_dtensor(w):  # a tensor every rank holds whole
        w = from_local(w, like.device_mesh, [Replicate()] * like.device_mesh.ndim)
    want, grad = [], []
    for pl in like.placements:
        if pl.is_shard() and pl.dim in dims:
            want.append(Shard(dims[pl.dim]))
            grad.append(Shard(dims[pl.dim]))
        else:
            want.append(Replicate())
            grad.append(Partial() if pl.is_shard() else Replicate())
    if list(w.placements) != want:
        w = w.redistribute(w.device_mesh, want)
    return w.to_local(grad_placements=grad)


def on_shards(fn, like, operands, out_dims, head_dim: Optional[int] = None):
    """``fn`` on each rank's local shards, the results as DTensors, for a
    computation with no DTensor rule (a recurrence whose einsums flatten the
    batch and heads into one dim sharded twice, on which DTensor's
    propagation fails; a convolution). ``like`` (a DTensor) sets the layout:
    its batch (dim 0) over the data axes and, with ``head_dim``, its heads
    over ``model`` (``kernel_placements``), the rest whole. Each of
    ``operands`` is a pair ``(tensor, dims)``, ``dims`` mapping a dim of
    ``like`` to the operand's dim that matches it: the operand is sharded
    there as ``like`` is, whole elsewhere, and its gradient summed over the
    ranks that split ``like`` on a dim it lacks (``local_operand``; a plain
    tensor counts as whole on every rank). Result ``i`` of ``fn`` comes back
    sharded as ``like`` is on the dims ``out_dims[i]`` maps. A plain
    ``like``: ``fn`` on the operands as they are."""
    if not is_dtensor(like):
        return fn(*(t for t, _ in operands))
    from torch.distributed.tensor import Replicate, Shard

    mesh = like.device_mesh
    layout = kernel_placements(mesh, like.shape[0], () if head_dim is None else (like.shape[head_dim],), 0, head_dim)
    placed = like if list(like.placements) == layout else like.redistribute(mesh, layout)
    outs = fn(*(local_operand(placed if t is like else t, placed, dims) for t, dims in operands))

    def placements_of(dims):
        return [Shard(dims[pl.dim]) if pl.is_shard() and pl.dim in dims else Replicate() for pl in placed.placements]

    return tuple(from_local(o, mesh, placements_of(d)) for o, d in zip(outs, out_dims))


def gather_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]``. Where ``x`` is a
    DTensor whose last dim no rank splits, each rank gathers from its local
    shard (``idx`` brought to ``x``'s placements): DTensor's own backward of
    ``gather`` scatters into a buffer of the global shape on every rank."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Replicate

    mesh, pl = x.device_mesh, list(x.placements)
    if not is_dtensor(idx):
        idx = from_local(idx, mesh, [Replicate()] * mesh.ndim)
    out = torch.gather(x.to_local(), -1, to_local_as(idx, mesh, pl)[..., None])[..., 0]
    return from_local(out, mesh, pl)


def topk_last(x, k: int):
    """``torch.topk(x, k, dim=-1)``. Where ``x`` is a DTensor, on each rank's
    local shard, with its last dim brought whole first: DTensor's cache of
    each op's output sharding leaves ``k`` out of its key, so a ``topk`` of
    another ``k`` on the same layout would read a stale global shape."""
    if not is_dtensor(x):
        return torch.topk(x, k, dim=-1)
    from torch.distributed.tensor import Replicate

    mesh, last = x.device_mesh, x.dim() - 1
    pl = [Replicate() if p.is_shard(last) or p.is_partial() else p for p in x.placements]
    vals, idx = torch.topk(to_local_as(x, mesh, pl), k, dim=-1)
    return from_local(vals, mesh, pl), from_local(idx, mesh, pl)


def from_local(x: torch.Tensor, mesh, placements, shape=None):
    """The DTensor whose local shard is ``x``; with ``shape`` (the global
    shape), contiguous strides of it, as a DTensor op would give its output
    (DTensor infers a stride of its own for a dim of one element, and the
    products after it may then round differently)."""
    from torch.distributed.tensor import DTensor

    if shape is None:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x, mesh, placements, run_check=False, shape=torch.Size(shape), stride=stride)


# ---------------------------------------------------------------------------
# in-place writes into a (sharded) cache
# ---------------------------------------------------------------------------


def write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``. Where ``dst`` is a DTensor, into its local shard:
    ``src`` is brought to ``dst``'s placements and each rank copies its own
    part (a recurrent state replaced whole, as a decode step replaces it)."""
    if not is_dtensor(dst):
        dst.copy_(full(src))
        return
    dst.to_local().copy_(to_local_as(src, dst.device_mesh, dst.placements))


def write_rows(dst: torch.Tensor, dim: int, start: int, src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)``, n = src.shape[dim]. Where
    ``dst`` is a DTensor, into its local shard: ``src`` is brought to ``dst``'s
    placements but on ``dim`` (whole there), and each rank writes the part of
    rows [start, start + n) its shard holds. The shards on ``dim`` must be
    even, as the cache plans make them."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, src.shape[dim]).copy_(full(src))
        return
    from torch.distributed.tensor import Replicate

    mesh = dst.device_mesh
    want = [Replicate() if pl.is_shard(dim) else pl for pl in dst.placements]
    src_l = to_local_as(src, mesh, want)
    dst_l = dst.to_local()
    offset, rows = shard_rows(dst, dim)
    lo, hi = max(start, offset), min(start + src.shape[dim], offset + rows)
    if lo < hi:
        dst_l.narrow(dim, lo - offset, hi - lo).copy_(src_l.narrow(dim, lo - start, hi - lo))
