"""Sharding plans: FSDP+TP(+EP/SP) partition-spec policy per (config, mesh,
shape) — the PyTorch twin of ``repro.sharding.plan``.

The policy is the reference's 2D sharding:
  * weights:   one dim over ``model`` (tensor-parallel), one over ``data``
               (ZeRO-3/FSDP);
  * activations: batch over (``pod``, ``data``); heads / ffn-hidden / vocab
               over ``model`` when divisible;
  * KV caches: sequence dim over ``model`` (flash-decode style), batch over
               the data axes; for batch-1 long-context cells the sequence dim
               is sharded over *all* axes (sequence parallelism).

Models never name mesh axes: they call ``plan.act(x, kind)`` and the plan
decides; with no mesh it returns its input. The spec rules are pure: they
take any mesh that has ``.shape`` (axis name -> size) and ``.axis_names``
(``AbstractMesh`` below, or a ``torch.distributed`` ``DeviceMesh`` through
``mesh_shape``), so they run without a process group. On a ``DeviceMesh`` a
spec becomes DTensor placements (``placements``): ``Shard(dim)`` on each mesh
dim the spec names for tensor dim ``dim``, ``Replicate()`` on the others.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite


class P(tuple):
    """PartitionSpec twin: one entry a tensor dim, each an axis name, a tuple
    of axis names, or None. Normalized as the reference's is: a one-name
    tuple becomes the name and an empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without devices: what the spec rules read."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> AbstractMesh:
    """The ``AbstractMesh`` of ``mesh``: itself, or a ``DeviceMesh``'s names and sizes."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch.distributed.device_mesh.DeviceMesh
        return AbstractMesh(tuple(mesh.mesh.shape), tuple(names))
    return AbstractMesh(tuple(mesh.shape[a] for a in mesh.axis_names), tuple(mesh.axis_names))


def _is_device_mesh(mesh) -> bool:
    return mesh is not None and getattr(mesh, "mesh_dim_names", None) is not None


def placements(mesh, spec: P, ndim: Optional[int] = None) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names it, else ``Replicate()``.
    A dim named by several axes is sharded over them in mesh order (the
    reference's major-to-minor order of an entry's names, which the plans
    always give in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None or (ndim is not None and dim >= ndim):
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(dim)
    return out


@dataclasses.dataclass
class ShardingPlan:
    mesh: Optional[Any]
    act_specs: Dict[str, P]
    dp_axes: Tuple[str, ...]
    tp_axis: Optional[str]
    #: where a model runs on each rank's own rows (the zero step): the sum of
    #: a tensor over the ranks that split the batch, differentiable -- what a
    #: statistic over the whole batch (BatchNorm's) needs; None elsewhere
    batch_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    #: the mesh axis over which the parameters' residency shards the model
    #: width d (the rows of column-parallel weights, the columns of
    #: row-parallel ones, ``_kernel_spec``): ``data`` under the train plans'
    #: ``param_pspecs``; None under 'serve' (``model`` only) and 'zero'
    d_axis: Optional[str] = None

    # -- activation constraints ---------------------------------------------
    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The twin of ``with_sharding_constraint``: the identity with no mesh
        (or no spec of that kind); on a ``DeviceMesh`` ``x`` is redistributed to
        the spec's placements. A plain tensor there is one that every rank
        holds whole (made from constants), taken as replicated first."""
        return self._to_spec(x, self.act_specs.get(kind))

    def new(self, shape, dtype: torch.dtype, kind: str, device, init: str = "zeros") -> torch.Tensor:
        """A new tensor of ``shape``, ``torch.zeros`` (or ``torch.empty``), in
        the placements of ``kind``'s spec. On a ``DeviceMesh`` each rank makes
        only its local shard; a whole tensor brought to the spec by ``act``
        is allocated whole on every rank first (deepseek-moe-16b's prefill
        cache at 32 x 32768 tokens: 224 GiB)."""
        spec = None if self.mesh is None else self.act_specs.get(kind)
        if spec is None or not _is_device_mesh(self.mesh):
            return getattr(torch, init)(shape, dtype=dtype, device=device)
        from torch.distributed import tensor as dtensor

        want = placements(self.mesh, _fit_spec(spec, shape, self.mesh), len(shape))
        return getattr(dtensor, init)(*shape, dtype=dtype, device_mesh=self.mesh, placements=want)

    def cols(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` (..., in, out) with its out dim sharded over the axes that the
        ``heads`` spec names for the heads (a product's output whose heads the
        plan splits) and its other dims whole: each rank holds the columns of
        its own heads and computes only those. GSPMD finds that layout for a
        replicated weight from the constraint on the product's output; DTensor
        would compute the product whole first. A replicated ``w`` is sliced
        where it lies (no collective); the identity with no mesh or no such
        axis."""
        spec = None if self.mesh is None else self.act_specs.get("heads")
        if spec is None or len(spec) <= 2 or spec[2] is None:
            return w
        return self._to_spec(w, P(*([None] * (w.dim() - 1)), spec[2]))

    def wo_input(self, x: torch.Tensor) -> torch.Tensor:
        """The attention's output as ``wo``'s input, (B, S, H·D), in the
        ``heads`` spec's batch layout with its columns over ``tp_axis``, as
        ``wo``'s rows: the identity on a tp plan's output, whether ``model``
        divides the heads (the heads' shards) or not (the row shares'
        exchange lands there; the ``heads`` spec, which leaves such heads
        whole, would gather it back); under 'zero' the batch over every axis."""
        spec = self.act_specs.get("heads")
        return x if spec is None else self._to_spec(x, P(spec[0], None, self.tp_axis))

    def batch_whole(self) -> bool:
        """Whether the batch is too small to split over the mesh's data axes
        (the long-context cells, batch 1): the plan then moves the
        parallelism into other dims, as the reference's program splits every
        decode product over both axes there."""
        return bool(self.dp_axes) and not self.spec("tokens")[0]

    def decode_stream(self, x: torch.Tensor) -> torch.Tensor:
        """A decode stream without its sequence dim, (B, d), in the layout
        the layers leave it in: where the batch is whole, d over ``d_axis``
        (a row-parallel product's reduced output keeps its columns' shards);
        ``x`` elsewhere."""
        if not (self.batch_whole() and self.d_axis):
            return x
        return self._to_spec(x, P(None, self.d_axis))

    def decode_cols(self, w: torch.Tensor) -> torch.Tensor:
        """``cols(w)`` where the batch is whole; ``w`` elsewhere, where the
        reference's program keeps a replicated decode weight whole on
        ``model`` (rwkv6's channel-mix receptance)."""
        return self.cols(w) if self.batch_whole() else w

    def _to_spec(self, x: torch.Tensor, spec: Optional[P]) -> torch.Tensor:
        """``x`` redistributed to ``spec``'s placements on a ``DeviceMesh``
        (the identity with no mesh or no spec); a plain tensor there is one
        that every rank holds whole (made from constants), taken as
        replicated first."""
        if spec is None or not _is_device_mesh(self.mesh):
            return x
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim, run_check=False)
        want = placements(self.mesh, _fit_spec(spec, x.shape, self.mesh), x.dim())
        return x if list(x.placements) == want else x.redistribute(self.mesh, want)

    def spec(self, kind: str) -> P:
        return self.act_specs.get(kind, P())

    def sharding(self, kind: str) -> Optional["NamedSharding"]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.act_specs.get(kind, P()))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def _divisible(n: int, axis_size: int) -> bool:
    return axis_size > 0 and n % axis_size == 0


def _fit_spec(spec: P, shape, mesh) -> P:
    """Drop any axis assignment that does not divide the dim (the reference's
    ``serve_step._fit_spec``; batch-1 long-context cells, 1500-frame cross-KV)."""
    sizes = mesh_shape(mesh).shape
    fixed = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            fixed.append(None)
            continue
        size = math.prod(sizes[a] for a in (entry if isinstance(entry, tuple) else (entry,)))
        fixed.append(entry if size and shape[i] % size == 0 else None)
    fixed += [None] * (len(shape) - len(fixed))
    return P(*fixed[: len(shape)])


def make_plan(
    cfg: ModelConfig,
    mesh: Optional[Any],
    suite: Optional[ShapeSuite] = None,
    *,
    variant: str = "baseline",
) -> ShardingPlan:
    """Build the activation-sharding plan.

    variant:
      'baseline' — Megatron-style TP: the residual stream is replicated over
                   the model axis between blocks.
      'sp'       — Megatron sequence parallelism: the residual stream is
                   sharded over the model axis on the SEQUENCE dim between
                   blocks.
      'zero'     — pure ZeRO-3 data parallelism: the batch is sharded over
                   EVERY mesh axis (model included) and no tensor dim is
                   contracted across devices; weights/optimizer are fully
                   sharded and gathered for the step.
      'serve'    — the baseline activation plan; it differs only in the
                   parameter residency (``serve_param_pspecs``).
    """
    if mesh is None:
        return ShardingPlan(None, {}, (), None)

    shape = mesh_shape(mesh)
    axes = shape.axis_names
    sizes = shape.shape
    if variant == "zero":
        return _make_zero_plan(cfg, mesh, suite)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    dp_size = 1
    for a in dp_axes:
        dp_size *= sizes[a]
    tp_size = sizes[tp] if tp else 1

    batch = suite.global_batch if suite else None
    # batch too small to split over dp -> leave unsharded, push parallelism
    # into the sequence dim instead (long_500k cells).
    dp = dp_axes if (batch is None or _divisible(batch, dp_size)) else ()
    seq_axes: Tuple[str, ...] = ()
    if not dp and tp:
        seq_axes = dp_axes + (tp,)  # SP: all axes onto the sequence dim

    heads_tp = tp if _divisible(cfg.n_heads, tp_size) else None
    kv_tp = tp if _divisible(cfg.n_kv_heads, tp_size) else None
    ffn_tp = tp if _divisible(cfg.d_ff, tp_size) else None
    vocab_tp = tp if _divisible(cfg.vocab, tp_size) else None

    # Megatron-SP: residual stream seq-sharded over the model axis between
    # blocks (only when the seq length divides; decode steps have seq=1)
    sp_seq = (
        tp
        if (
            variant == "sp"
            and tp
            and suite is not None
            and suite.kind in ("train", "prefill")
            and _divisible(suite.seq_len, tp_size)
        )
        else None
    )

    specs: Dict[str, P] = {
        "tokens": P(dp, None),
        "hidden": P(dp, sp_seq, None),
        "heads": P(dp, None, heads_tp, None),
        "kv_heads": P(dp, None, kv_tp, None),
        "ffn": P(dp, None, ffn_tp),
        "logits": P(dp, None, vocab_tp),
        "last_logits": P(dp, vocab_tp),
        # KV cache (L, B, S, KVH, D): sequence over model (flash-decode);
        # falls back to SP over everything for batch-1 long-context cells.
        "cache": P(None, dp, seq_axes if seq_axes else tp, None, None),
        # recurrent state (L, B, H, K, V) — batch over dp, heads over tp.
        "state": P(None, dp if dp else None, heads_tp, None, None),
        # decode-step activations (B, 1, ...)
        "decode_hidden": P(dp, None, None),
        "decode_heads": P(dp, None, heads_tp, None),
        # MoE grouped-GEMM tensors (E, C, d/f): experts over model (EP),
        # capacity rows over data so both mesh axes stay busy.
        "expert_group": P(tp, dp if dp else None, None),
        "expert_hidden": P(tp, dp if dp else None, None),
        # per-example grouped dispatch (B, E, C, d): batch over data, experts
        # over model.
        "grouped": P(dp, tp, None, None),
        # frames/patches stubs (B, T, D)
        "frames": P(dp, None, None),
    }
    return ShardingPlan(mesh, specs, dp_axes, tp, d_axis="data" if "data" in axes and variant != "serve" else None)


def _make_zero_plan(cfg: ModelConfig, mesh, suite: Optional[ShapeSuite]) -> ShardingPlan:
    """ZeRO-3 plan: batch over as many axes as divide it; nothing else
    sharded in activations (each device computes whole examples)."""
    shape = mesh_shape(mesh)
    axes, sizes = shape.axis_names, shape.shape
    # choose the largest suffix of axes whose product divides the batch,
    # preferring to use every axis (full data parallelism)
    batch = suite.global_batch if suite else None
    dp: Tuple[str, ...] = ()
    if batch is not None:
        for take in range(len(axes), 0, -1):
            size = 1
            for a in axes[-take:]:
                size *= sizes[a]
            if batch % size == 0:
                dp = axes[-take:]
                break
    else:
        dp = axes
    dp_entry = dp if dp else None
    specs: Dict[str, P] = {
        "tokens": P(dp_entry, None),
        "hidden": P(dp_entry, None, None),
        "heads": P(dp_entry, None, None, None),
        "kv_heads": P(dp_entry, None, None, None),
        "ffn": P(dp_entry, None, None),
        "logits": P(dp_entry, None, None),
        "last_logits": P(dp_entry, None),
        "cache": P(None, dp_entry, None, None, None),
        "state": P(None, dp_entry, None, None, None),
        "decode_hidden": P(dp_entry, None, None),
        "decode_heads": P(dp_entry, None, None, None),
        "expert_group": P(None, dp_entry, None),
        "expert_hidden": P(None, dp_entry, None),
        "grouped": P(dp_entry, None, None, None),
        "frames": P(dp_entry, None, None),
    }
    return ShardingPlan(mesh, specs, dp, None)


# ---------------------------------------------------------------------------
# parameter specs, by the reference's leaf-name rules
# ---------------------------------------------------------------------------

# column-parallel (out dim -> model, in dim -> data)
_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_lm", "w_qkv")
# row-parallel (in dim -> model, out dim -> data)
_ROW = ("wo", "w_down", "w_out")
# embedding tables (vocab -> model, d -> data)
_EMB = ("table",)
# expert-stacked kernels: leading expert dim -> model (EP), then data
_EXPERT_COL = ("e_gate", "e_up", "e_in")
_EXPERT_ROW = ("e_down", "e_out")


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any, name: str = "") -> Any:
    """``fn(leaf name, leaf)`` over nested dicts and lists; a leaf's name is
    the last dict key on its path (a list index is not a name), as the
    reference's ``_leaf_name`` reads a path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_name(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_name(fn, v, name) for v in tree]
    return fn(name, tree)


def _ndim(leaf) -> int:
    return len(leaf.shape)


def _kernel_spec(name: str, ndim: int) -> P:
    """Build a spec for an (optionally L-stacked) kernel of rank ``ndim``."""

    def pad(spec_tail: Tuple) -> P:
        lead = (None,) * (ndim - len(spec_tail))
        return P(*(lead + spec_tail))

    if name in _EMB:
        return P("model", "data") if ndim == 2 else pad(("model", "data"))
    if name in _EXPERT_COL:
        return pad(("model", "data", None))
    if name in _EXPERT_ROW:
        return pad(("model", None, "data"))
    if name in _COL and ndim >= 2:
        return pad(("data", "model"))
    if name in _ROW and ndim >= 2:
        return pad(("model", "data"))
    return P()  # replicate (norm scales, biases, small vectors)


def serve_param_pspecs(params, mesh):
    """Serving parameter specs: pure TP residency — weights sharded over the
    ``model`` axis ONLY, replicated over data axes."""
    sizes = mesh_shape(mesh).shape

    def rule(name, leaf):
        spec = _kernel_spec(name, _ndim(leaf))
        fixed = [ax if ax == "model" else None for ax in spec]
        fixed += [None] * (_ndim(leaf) - len(fixed))
        out = []
        for dim, ax in zip(leaf.shape, fixed):
            size = sizes[ax] if isinstance(ax, str) else 1
            out.append(ax if ax and dim % size == 0 else None)
        return P(*out) if any(a is not None for a in out) else P()

    return tree_map_with_name(rule, params)


def zero_param_pspecs(params, mesh):
    """ZeRO-3 parameter specs: shard the largest dim of every leaf over the
    FULL merged mesh (every axis), falling back to progressively smaller
    axis groups until one divides. Norm vectors and small leaves replicate."""
    shape = mesh_shape(mesh)
    axes, sizes = shape.axis_names, shape.shape
    groups = [axes[i:] for i in range(len(axes))]  # full, then suffixes

    def rule(_name, leaf):
        ndim = _ndim(leaf)
        if ndim == 0 or math.prod(leaf.shape) < 1 << 14:
            return P()  # tiny: replicate
        order = sorted(range(ndim), key=lambda i: -leaf.shape[i])
        for grp in groups:
            size = 1
            for a in grp:
                size *= sizes[a]
            for dim in order:
                if leaf.shape[dim] % size == 0:
                    spec = [None] * ndim
                    spec[dim] = grp if len(grp) > 1 else grp[0]
                    return P(*spec)
        return P()

    return tree_map_with_name(rule, params)


def param_pspecs(params):
    """Partition-spec tree matching ``params`` by leaf-name rules."""

    def rule(name, leaf):
        spec = _kernel_spec(name, _ndim(leaf))
        return spec if any(a is not None for a in spec) else P()

    return tree_map_with_name(rule, params)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def validate_pspecs(params, specs, mesh):
    """Replace any axis assignment that does not divide the dim (safety net)."""
    sizes = mesh_shape(mesh).shape

    def fix(leaf, spec):
        new = []
        for i, ax in enumerate(spec):
            if ax is None:
                new.append(None)
                continue
            size = sizes[ax] if isinstance(ax, str) else 1
            new.append(ax if leaf.shape[i] % size == 0 else None)
        new += [None] * (_ndim(leaf) - len(new))
        return P(*new)

    return _map2(fix, params, specs)


def named_shardings(params_or_specs, specs, mesh):
    """A ``NamedSharding`` for each leaf of ``specs``, on ``mesh``."""
    return _map2(lambda _, s: NamedSharding(mesh, s), params_or_specs, specs)
