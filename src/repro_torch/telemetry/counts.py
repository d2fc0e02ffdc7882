"""Op counts of one traced step: FLOPs, bytes, collectives and a fingerprint.

The port's counterpart of the reference's ``telemetry/hlo.py``. The reference
reads a compiled XLA program; PyTorch runs eagerly and has none, so the port
counts the step as it runs, once, under two dispatch modes:

  * FLOPs by ``torch.utils.flop_counter.FlopCounterMode``: 2·M·N·K for every
    matrix product, 2·out·K_window for every convolution, forward and
    backward (the reference counts ``dot`` and ``convolution`` the same way);
  * bytes by ``OpLog``, which adds up each aten op's input and output tensor
    bytes. That is an upper bound on the step's HBM traffic, not a
    measurement of it: every op is counted as if it read each input from
    memory and wrote each output back, with no fusion and no reuse from a
    cache. Views move nothing and are not counted;
  * collectives from the c10d ops in the trace, summarised under the
    reference's keys (``collective_summary``);
  * a fingerprint: the first 16 hex digits of the sha256 of the op sequence
    with each op's tensor shapes, as the reference hashes its program text;
  * the type the products compute in (the most common type of the first
    operand of the ops FlopCounterMode counts), which picks the roofline's
    peak: the trio's f32 convolutions run outside the tensor cores.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_COLLECTIVE_KINDS = (  # aten-level name fragment -> the reference's HLO name
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
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


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(name: str) -> str:
    for fragment, kind in _COLLECTIVE_KINDS:
        if fragment in name:
            return kind
    return "collective-permute"  # send, recv, broadcast: point to point on a ring


class OpLog(TorchDispatchMode):
    """Logs every aten op the step dispatches: its name and tensor shapes,
    the bytes of its tensors (views excluded) and its collectives."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []
        self.bytes = 0
        self.collectives: List[CollectiveOp] = []
        self.product_dtypes: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops.append(f"{func}{[tuple(t.shape) for t in ins]}->{[tuple(t.shape) for t in outs]}")
        if func.overloadpacket in flop_registry and ins:
            self.product_dtypes[ins[0].dtype] += 1
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            group = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
            self.collectives.append(CollectiveOp(
                kind=_collective_kind(func.__name__),
                bytes_result=sum(_nbytes(t) for t in (outs or ins)),
                group_size=group, multiplier=1, op_name=str(func),
            ))
        return out

    def fingerprint(self) -> str:
        return hashlib.sha256("\n".join(self.ops).encode()).hexdigest()[:16]


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
            f"{len(ops)} c10d ops in the traced step, over the default process group"
            if ops else "no c10d op in the traced step: it ran on one device in one process"
        ),
    }


@dataclasses.dataclass(frozen=True)
class StepCounts:
    flops: float
    bytes: float
    fingerprint: str
    collectives: Dict
    product_dtype: torch.dtype


def count_step(fn: Callable[[], Any]) -> Tuple[Any, StepCounts]:
    """Run ``fn()`` once under the counters; returns its result and the counts."""
    log = OpLog()
    with FlopCounterMode(display=False) as flops, log:
        out = fn()
    return out, StepCounts(
        flops=float(flops.get_total_flops()),
        bytes=float(log.bytes),
        fingerprint=log.fingerprint(),
        collectives=collective_summary(log.collectives),
        product_dtype=log.product_dtypes.most_common(1)[0][0],
    )
