"""Ring collective-matmul: compute/communication overlap primitive — the
PyTorch twin of ``repro.runtime.ring``.

``ring_ag_matmul`` computes ``y = x @ W`` where ``x`` is batch-sharded and
``W`` is column-sharded over the same ranks, *without* a blocking all-gather
of W: at ring step k each rank multiplies against the weight shard it holds
while the shard travels on to its neighbour. Each step posts the exchange
(``isend`` to the rank before it, ``irecv`` from the one after), issues its
matmul, and only then waits for the exchange, so the transfer hides behind
the product, as the reference's ``ppermute`` beside its einsum does. Checked
against the all-gather oracle (``tests/test_torch_ring_pipeline.py``).

Every rank of ``group`` (None: the default group) calls a function with its
own shards; products accumulate in f32, the reference's
``preferred_element_type``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as tdist


def _ring(group):
    n = tdist.get_world_size(group)
    me = tdist.get_rank(group)
    peer = lambda r: r if group is None else tdist.get_global_rank(group, r)  # noqa: E731
    return n, me, peer((me - 1) % n), peer((me + 1) % n)


def _shift(w: torch.Tensor, to: int, frm: int, group):
    """Start sending ``w`` to rank ``to`` and receiving its successor from
    ``frm``; returns (the buffer being filled, the requests)."""
    nxt = torch.empty_like(w)
    reqs = tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, w, to, group),
                                    tdist.P2POp(tdist.irecv, nxt, frm, group)])
    return nxt, reqs


def ring_ag_matmul(x: torch.Tensor, w_shard: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """x: (B_local, d); w_shard: (d, f_local) — this rank's column block.

    Returns (B_local, n * f_local): this rank's batch rows against the full
    weight, one column block a ring step.
    """
    n, me, to, frm = _ring(group)
    f_local = w_shard.shape[1]
    out = torch.zeros((x.shape[0], n * f_local), dtype=torch.float32, device=x.device)
    w = w_shard.contiguous()
    xf = x.float()
    for k in range(n):
        # the shard held now came from rank (me + k) % n: its column block
        blk = (me + k) % n
        pending = _shift(w, to, frm, group) if k < n - 1 else None
        out[:, blk * f_local:(blk + 1) * f_local] = xf @ w.float()
        if pending is not None:
            w, reqs = pending
            for r in reqs:
                r.wait()
    return out


def ring_rs_matmul(x: torch.Tensor, w_shard: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """x: (B_local, n * f_local), batch-sharded; w_shard: (f_local, d) — this
    rank's *row* block of a (n * f_local, d) matrix. Returns (B_local, d), the
    full sum ``sum_k x[:, blk_k] @ W_k``, accumulated around the ring so that
    each step's exchange overlaps the next product."""
    n, me, to, frm = _ring(group)
    f_local = w_shard.shape[0]
    acc = torch.zeros((x.shape[0], w_shard.shape[1]), dtype=torch.float32, device=x.device)
    w = w_shard.contiguous()
    for k in range(n):
        blk = (me + k) % n
        pending = _shift(w, to, frm, group) if k < n - 1 else None
        acc += x[:, blk * f_local:(blk + 1) * f_local].float() @ w.float()
        if pending is not None:
            w, reqs = pending
            for r in reqs:
                r.wait()
    return acc
