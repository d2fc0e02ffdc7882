"""The reference's HBM traffic model and collective accounting, over the
port's aten trace (PyTorch twin of ``repro.telemetry.hlo``).

The reference walks a compiled XLA program (post-SPMD, so every shape is a
device's shard) and prices it with a fused-TPU traffic model. The port has
no compiled program: ``telemetry/counts.py::OpLog`` traces one step as it
runs, each op on the rank's local shards, and this module prices that trace
with the reference's rules (``hlo_flops_bytes``):

  * FLOPs: 2·M·N·K for every product and 2·out·K_window for every
    convolution, forward and backward, on local shards (``OpLog`` counts them
    with ``torch.utils.flop_counter``'s formulas);
  * bytes: the operand and result bytes of the aten counterparts of the ops
    the reference says necessarily touch HBM (``_HBM_OPS``), plus the
    program's inputs (state, batch, cache) read once. Elementwise ops,
    type conversions and copies count as fused, as the reference assumes:

    =====================================  =====================================
    the reference's HLO op (``_HBM_OPS``)   its aten counterparts (``HBM_OPS``)
    =====================================  =====================================
    dot                                    mm, addmm, bmm, baddbmm, addbmm, mv,
                                           addmv, dot, _scaled_mm
    convolution                            convolution, _convolution,
                                           convolution_backward
    gather, scatter                        gather, scatter, scatter_add,
                                           scatter_reduce, index, index_put,
                                           _index_put_impl, index_add,
                                           index_select, index_copy,
                                           embedding, embedding_dense_backward
    dynamic-slice, dynamic-update-slice    none: eager code slices with views
                                           and writes a slice with ``copy_``,
                                           a copy, counted as fused
    reduce                                 sum, mean, amax, amin, max, min,
                                           prod, logsumexp, var, var_mean, std,
                                           std_mean, norm, linalg_vector_norm,
                                           argmax, argmin, all, any, cumsum;
                                           _softmax, _log_softmax and their
                                           backward; native_layer_norm,
                                           native_batch_norm (and the
                                           _native_batch_norm_legit forms),
                                           native_group_norm, and their
                                           backward: each reads its input whole
    reduce-window                          max_pool2d(_with_indices), avg_pool2d,
                                           _adaptive_avg_pool2d
    sort                                   sort, topk, argsort
    all-gather, all-reduce,                the c10d ops: all_gather_into_tensor,
    reduce-scatter, all-to-all,            all_reduce, reduce_scatter_tensor,
    collective-permute                     all_to_all_single, their legacy
                                           forms, broadcast, send/recv,
                                           shard_dim_alltoall
    none off the TPU                       the hand-written kernels' entries
                                           (``KERNEL_OPS``, on the card): each
                                           reads its operands and writes its
                                           outputs once
    =====================================  =====================================

    The reference's program has no op for its kernels off the TPU: there its
    ``ops`` run their plain ``ref`` versions, whose products and reductions
    it counts as above. On the card the port's kernels run instead, and each
    launch is one entry of the trace (``OpLog.record_kernel``).

  * collectives: ``CollectiveOp``, ``shape_bytes`` and ``collective_summary``
    are ``telemetry/counts.py``'s, re-exported here under the reference's
    names; each op carries the size of its own process group.

The reference's loop multipliers (``computation_multipliers``, for the
``while`` loops of ``lax.scan``) have no counterpart: an eager trace runs and
records every layer, so every op is counted as often as it runs.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.telemetry.counts import KERNEL_OPS, CollectiveOp, OpLog, collective_summary, shape_bytes

__all__ = ["CollectiveOp", "HBM_OPS", "collective_summary", "hlo_flops_bytes", "shape_bytes"]

#: aten ops (by ``overloadpacket.__name__``) whose operands and results
#: stream HBM on a fused backend: the table of the module docstring
HBM_OPS = frozenset(
    # dot, convolution
    "mm addmm bmm baddbmm addbmm mv addmv dot _scaled_mm convolution _convolution convolution_backward "
    # gather, scatter
    "gather scatter scatter_add scatter_reduce index index_put _index_put_impl index_add index_select "
    "index_copy embedding embedding_dense_backward "
    # reduce
    "sum mean amax amin max min prod logsumexp var var_mean std std_mean norm linalg_vector_norm argmax "
    "argmin all any cumsum _softmax _log_softmax _softmax_backward_data _log_softmax_backward_data "
    "native_layer_norm native_layer_norm_backward native_batch_norm native_batch_norm_backward "
    "_native_batch_norm_legit _native_batch_norm_legit_functional _native_batch_norm_legit_no_training "
    "native_group_norm native_group_norm_backward "
    # reduce-window
    "max_pool2d max_pool2d_with_indices avg_pool2d _adaptive_avg_pool2d "
    # sort
    "sort topk argsort "
    # collectives (c10d_functional, legacy c10d, DTensor's all-to-all)
    "all_reduce all_gather_into_tensor reduce_scatter_tensor all_to_all_single broadcast allreduce_ "
    "allgather_ _allgather_base_ allgather_into_tensor_coalesced_ reduce_scatter_ _reduce_scatter_base_ "
    "alltoall_ alltoall_base_ broadcast_ send recv_ shard_dim_alltoall".split()
) | KERNEL_OPS  # the hand-written kernels: the reference's program has no such op off the TPU


def hlo_flops_bytes(log: OpLog, inputs: Any) -> Dict[str, float]:
    """FLOP and HBM-byte estimate of a traced step by the reference's fused
    traffic model (module docstring): every op's FLOPs, the operand and
    result bytes of the ``HBM_OPS`` and the bytes of ``inputs`` (the step's
    arguments, a DTensor by its local shard) once."""
    flops = sum(f for _, _, _, f in log.trace)
    bytes_ = sum(i + o for name, i, o, _ in log.trace if name in HBM_OPS)
    return {"flops": float(flops), "bytes": float(bytes_ + shape_bytes(inputs))}
