"""Op counts of one traced step: FLOPs, bytes, collectives and a fingerprint.

The reference reads a compiled XLA program; PyTorch runs eagerly and has
none, so the port counts the step as it runs, once, under one dispatch mode,
``OpLog``, which sees every aten op:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (``flop_registry``):
    2·M·N·K for every matrix product, 2·out·K_window for every convolution,
    forward and backward (the reference counts ``dot`` and ``convolution``
    the same way);
  * each op's input and output tensor bytes, in ``OpLog.trace`` (views move
    nothing and are left out), which ``telemetry/hlo.py`` reads through the
    reference's fused traffic model (``hbm_bytes``). Their sum over every op
    would be an upper bound on the step's HBM traffic, with no fusion and no
    reuse from a cache; nothing records it;
  * collectives from the c10d ops in the trace, each with the size of its
    own process group (a ``_c10d_functional`` op's ``group_name``, a legacy
    ``c10d`` op's ``ProcessGroup``), summarised under the reference's keys
    (``collective_summary``); an all-to-all with split sizes priced by what
    this rank sends to the others, read from them;
  * a fingerprint: the first 16 hex digits of the sha256 of the op sequence
    with each op's tensor shapes, as the reference hashes its program text;
  * the type the products compute in (the most common type of the first
    operand of the ops with a FLOP formula), which picks the roofline's
    peak: the trio's f32 convolutions run outside the tensor cores;
  * the bytes of the storages the counted ops hold live, and their peak
    (``live``, ``peak``): each output's storage counted once from its first
    op until Python frees it, beside the inputs ``hold`` names;
  * the hand-written kernels (``KERNEL_OPS``). On the card a kernel wrapper
    launches its kernel through ``ctypes``, which dispatches no aten op, so
    the wrapper reports each launch to the active logs itself
    (``record_kernel``): one entry, under the kernel's name, with its
    operands, its outputs and the FLOPs of the products it performs on the
    pairs it does not mask (the formula beside each wrapper). ``OpLog``
    takes it into ``ops``, ``trace``, ``flops`` and ``product_dtypes`` as it
    takes an aten op, and raises for an entry it cannot take. Off the card
    the wrappers run their plain versions, aten ops counted as before.

Under a mesh every count is a device's, as the reference's post-SPMD program
is: an op on DTensors is let through (``NotImplemented``) to DTensor's own
dispatch, and ``OpLog`` counts the ops that run on the rank's local shards,
with the collectives DTensor issues between them. An op on plain tensors,
which every rank computes whole, counts whole. Gloo has no all-to-all, so
on a ``cpu`` mesh DTensor gathers and keeps its chunk instead; ``count_step``
records that pair as the all-to-all it stands for, whose result is the chunk.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import sys
import weakref
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional", "_dtensor")
#: queries of a tensor's metadata, which reach a dispatch mode for tensor
#: subclasses (fake tensors, DTensors' shards) and not for plain tensors:
#: they move nothing, and the fingerprint of a step leaves them out
_METADATA_OPS = frozenset("sym_size sym_stride sym_numel sym_storage_offset is_contiguous "
                          "is_strides_like_format is_non_overlapping_and_dense dim size stride numel "
                          "storage_offset layout".split())
_COLLECTIVE_KINDS = (  # aten-level name fragment -> the reference's HLO name
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    # point to point on a ring
    ("broadcast", "collective-permute"), ("send", "collective-permute"), ("recv", "collective-permute"),
)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_result: int
    group_size: int
    multiplier: int
    op_name: str

    @property
    def wire_bytes(self) -> float:
        """Per-device ring-cost bytes on the wire for one execution."""
        n, R = self.group_size, self.bytes_result
        if n <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * R * (n - 1) / n
        if self.kind == "all-gather":
            return R * (n - 1) / n  # R = gathered (full) result
        if self.kind == "reduce-scatter":
            return R * (n - 1)  # R = scattered shard; input = n*R
        if self.kind == "all-to-all":
            return R * (n - 1) / n
        return float(R)  # collective-permute

    @property
    def total_wire_bytes(self) -> float:
        return self.wire_bytes * self.multiplier

    @property
    def total_raw_bytes(self) -> float:
        return float(self.bytes_result) * self.multiplier


@dataclasses.dataclass
class AllToAllOp(CollectiveOp):
    """An all-to-all with split sizes (``CollectiveOp`` is the reference's,
    which prices one at R·(n-1)/n over its whole group): on the wire, the
    bytes this rank sends to the other ranks of its group, read from its
    splits (``_sent_bytes``). An even one sends R·(n-1)/n."""

    sent_bytes: int = 0

    @property
    def wire_bytes(self) -> float:
        return float(self.sent_bytes) if self.group_size > 1 else 0.0


#: the hand-written kernels' entries (``record_kernel``), by the name each
#: wrapper reports: K1, K2, K3, K4 and K5
KERNEL_OPS = frozenset(
    ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "decode_attention", "wkv6_scan")
)
#: the logs active in this process, innermost last. A process-wide list and
#: not the dispatch mode's own thread-local stack: autograd runs a CUDA
#: backward, and so the backward kernels' launches, on a thread of its own.
_ACTIVE: List["OpLog"] = []


def recording() -> bool:
    """Whether an ``OpLog`` is active, so that a kernel wrapper has a launch
    to report (and, for the decode kernel, a device length to read)."""
    return bool(_ACTIVE)


def record_kernel(name: str, ins: List[torch.Tensor], outs: List[torch.Tensor], flops: float) -> None:
    """Report one launch of the hand-written kernel ``name`` to every active
    ``OpLog``: the tensors it reads (``ins``; a view of only what it reads,
    as the decode kernel's valid cache rows), those it writes (``outs``) and
    the FLOPs of its products. Each log raises if it cannot take the entry."""
    for log in tuple(_ACTIVE):
        log.record_kernel(name, ins, outs, flops)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def shape_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (a tensor, or nested containers of
    them); a DTensor counts its local shard, what one device holds."""
    from repro_torch.sharding import dist

    return sum(t.numel() * t.element_size() for t in map(dist.local, _tensors(tree)))


def _collective_kind(name: str) -> Optional[str]:
    """The reference's name of a c10d op's collective, or None for an op
    that moves nothing (``wait_tensor``, ``barrier``, autograd wrappers)."""
    for fragment, kind in _COLLECTIVE_KINDS:
        if fragment in name:
            return kind
    return None


def _group(args):
    """The process group a c10d op runs over: its ``ProcessGroup`` argument
    (legacy ops) or the group its ``group_name`` names (functional ops);
    None where it names none (the default group)."""
    import torch.distributed as tdist
    from torch.distributed.distributed_c10d import _resolve_process_group

    flat = tree_flatten(args)[0]
    for a in flat:
        if isinstance(a, tdist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return tdist.ProcessGroup.unbox(a)
    for a in reversed(flat):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (RuntimeError, ValueError, KeyError):
                continue
    return None


def _group_size(args) -> int:
    """The size of the process group a c10d op runs over (``_group``)."""
    import torch.distributed as tdist

    group = _group(args)
    if group is not None:
        return group.size()
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _sent_bytes(func, args, kwargs) -> Optional[int]:
    """The bytes an all-to-all sends to the other ranks of its group: its
    input's rows (dim 0) of ``input_split_sizes`` but this rank's own, in
    the group's rank order. None where the op gives no split sizes (even)."""
    import torch.distributed as tdist

    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    splits, x = named.get("input_split_sizes"), named.get("input")
    if not splits or not isinstance(x, torch.Tensor) or x.dim() == 0:
        return None
    group = _group((args, kwargs))
    rank = group.rank() if group is not None else tdist.get_rank()
    row = x.numel() // x.shape[0] * x.element_size() if x.shape[0] else 0
    return int((sum(splits) - splits[rank]) * row)


class OpLog(TorchDispatchMode):
    """Logs every aten op the step dispatches on local tensors: its name and
    tensor shapes, FLOPs, its collectives, and the storages it leaves live.
    ``trace`` keeps, for each op but views, (name, input bytes, output bytes,
    FLOPs) for the traffic model of ``telemetry/hlo.py``."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.ops: List[str] = []
        self.flops = 0.0
        self.trace: List[Tuple[str, int, int, float]] = []
        self.collectives: List[CollectiveOp] = []
        self.product_dtypes: Counter = Counter()
        self.alltoall_depth = 0  # > 0 inside DTensor's all-to-all (see ``_alltoall_recorded``)
        self._fake_mode = None
        self.live = self.peak = 0
        self._storages: Dict[int, int] = {}  # StorageImpl -> bytes, while Python holds it

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local shard)
        as live from now on, as the step's inputs are."""
        from repro_torch.sharding import dist

        for t in _tensors(tree):
            self._track(dist.local(t))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_mode = active_fake_mode()
        out = super().__enter__()
        _ACTIVE.append(self)
        return out

    def __exit__(self, exc_type, exc_value, traceback):
        _ACTIVE.remove(self)
        return super().__exit__(exc_type, exc_value, traceback)

    def record_kernel(self, name: str, ins: List[torch.Tensor], outs: List[torch.Tensor], flops: float) -> None:
        """Take one launch of a hand-written kernel (``record_kernel``) as
        ``__torch_dispatch__`` takes an aten op. Raises for an entry it cannot
        take: a name outside ``KERNEL_OPS`` (the traffic model would not
        count its bytes) or FLOPs that are not a finite count."""
        if name not in KERNEL_OPS:
            raise ValueError(f"kernel {name!r} cannot be recorded: not one of {sorted(KERNEL_OPS)}")
        flops = float(flops)
        if not 0.0 <= flops < float("inf"):
            raise ValueError(f"kernel {name!r} cannot be recorded with {flops} FLOPs")
        self.ops.append(f"{name}{[tuple(t.shape) for t in ins]}->{[tuple(t.shape) for t in outs]}")
        self.flops += flops
        self.product_dtypes[ins[0].dtype] += 1
        for t in outs:
            self._track(t)
        self.trace.append((name, shape_bytes(ins), shape_bytes(outs), flops))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            return out  # DTensor's sharding propagation (``propagation_apart``): not run on a device
        if func.namespace == "prim" or func.overloadpacket.__name__ in _METADATA_OPS:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops.append(f"{func}{[tuple(t.shape) for t in ins]}->{[tuple(t.shape) for t in outs]}")
        flops = 0.0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            self.flops += flops
            if ins:
                self.product_dtypes[ins[0].dtype] += 1
        for t in outs:
            self._track(t)
        in_bytes, out_bytes = shape_bytes(ins), shape_bytes(outs)
        if not func.is_view:
            self.trace.append((func.overloadpacket.__name__, in_bytes, out_bytes, flops))
        kind = _collective_kind(func.__name__) if func.namespace in _COLLECTIVE_NAMESPACES else None
        if kind is not None:
            group = _group_size((args, kwargs))
            result, sent = out_bytes or in_bytes, None
            if self.alltoall_depth and kind == "all-gather":
                kind, result = "all-to-all", result // max(group, 1)  # the chunk DTensor keeps
            elif kind == "all-to-all":
                sent = _sent_bytes(func, args, kwargs)
            op = dict(kind=kind, bytes_result=result, group_size=group, multiplier=1, op_name=str(func))
            self.collectives.append(CollectiveOp(**op) if sent is None else AllToAllOp(**op, sent_bytes=sent))
        return out

    def fingerprint(self) -> str:
        return hashlib.sha256("\n".join(self.ops).encode()).hexdigest()[:16]


@contextlib.contextmanager
def _alltoall_recorded(log: OpLog):
    """Inside the block DTensor's ``shard_dim_alltoall`` marks ``log`` while
    it runs, so that the gather it falls back to on a ``cpu`` mesh is
    recorded as the all-to-all it stands for (rebound in each module of
    ``torch.distributed.tensor`` that holds the function)."""
    from torch.distributed.tensor import _collective_utils

    orig = _collective_utils.shard_dim_alltoall

    def marked(*args, **kwargs):
        log.alltoall_depth += 1
        try:
            return orig(*args, **kwargs)
        finally:
            log.alltoall_depth -= 1

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in holders:
        m.shard_dim_alltoall = marked
    try:
        yield
    finally:
        for m in holders:
            m.shard_dim_alltoall = orig


@contextlib.contextmanager
def propagation_apart():
    """Inside the block, where a fake mode is active (the dry-run), DTensor
    derives each op's global output shape in a fake mode of its own: it runs
    the op on fake tensors of the global shapes, in the fake mode it detects
    (the trace context's first), and ``OpLog`` counts only the ops of the
    mode it started in. Without an active fake mode DTensor
    makes a mode of its own anyway."""
    from torch._guards import TracingContext, active_fake_mode, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode

    if active_fake_mode() is None:
        yield
        return
    with tracing(TracingContext(FakeTensorMode(allow_non_fake_inputs=True))):
        yield


def collective_summary(ops: List[CollectiveOp]) -> Dict:
    """The reference's summary of a program's collectives, over the ops a
    traced step ran (each counted once per execution, so no loop multiplier),
    plus ``groups``, the ranks each op spans, and a ``detail`` line."""
    by_kind: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "raw_bytes": 0.0, "wire_bytes": 0.0}
    )
    for op in ops:
        k = by_kind[op.kind]
        k["count"] += op.multiplier
        k["raw_bytes"] += op.total_raw_bytes
        k["wire_bytes"] += op.total_wire_bytes
    top = sorted(ops, key=lambda o: -o.total_wire_bytes)[:12]
    return {
        "per_device_raw_bytes": sum(o.total_raw_bytes for o in ops),
        "per_device_wire_bytes": sum(o.total_wire_bytes for o in ops),
        "n_collective_sites": len(ops),
        "by_kind": {k: v for k, v in by_kind.items()},
        "top_ops": [
            {
                "kind": o.kind,
                "bytes": o.bytes_result,
                "group": o.group_size,
                "x": o.multiplier,
                "wire": o.total_wire_bytes,
                "op_name": o.op_name[-110:],
            }
            for o in top
        ],
        "groups": [list(range(o.group_size)) for o in ops],
        "detail": (
            f"{len(ops)} c10d ops in the traced step, each over its own process group"
            if ops else "no c10d op in the traced step: it ran on one device in one process"
        ),
    }


@dataclasses.dataclass(frozen=True)
class StepCounts:
    flops: float
    hbm_bytes: float  # the reference's fused traffic model (telemetry/hlo.py)
    fingerprint: str
    collectives: Dict
    product_dtype: torch.dtype
    #: the hand-written kernels' entries: name -> (launches, FLOPs)
    kernels: Dict[str, Tuple[int, float]] = dataclasses.field(default_factory=dict)


def kernel_entries(log: OpLog) -> Dict[str, Tuple[int, float]]:
    """{kernel name: (entries, FLOPs)} of the hand-written kernels in the
    log's trace."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, _, _, flops in log.trace:
        if name in KERNEL_OPS:
            n, f = out.get(name, (0, 0.0))
            out[name] = (n + 1, f + flops)
    return out


def count_step(fn: Callable[[], Any], inputs: Any) -> Tuple[Any, StepCounts]:
    """Run ``fn()`` once under the counters; returns its result and the
    counts. ``inputs`` are the step's arguments (state, batch, cache), which
    the traffic model reads from memory once."""
    from repro_torch.telemetry.hlo import hlo_flops_bytes

    log = OpLog()
    with propagation_apart(), _alltoall_recorded(log), log:
        out = fn()
    dtypes = log.product_dtypes.most_common(1)
    return out, StepCounts(
        flops=log.flops,
        hbm_bytes=hlo_flops_bytes(log, inputs)["bytes"],
        fingerprint=log.fingerprint(),
        collectives=collective_summary(log.collectives),
        product_dtype=dtypes[0][0] if dtypes else torch.bfloat16,
        kernels=kernel_entries(log),
    )
