"""Kinds of device operations by name, and the flash kernels' roofline
share, for the readers of the trace.

The flash attention kernels of ``repro_torch/kernels/csrc`` by their entry
points; library matrix products by the marks of cuBLAS's and CUTLASS's
kernel names (a frozen copy of ``examples/profile_train_torch.py``'s
``GEMM_MARKS``); copies and sets by the profiler's names for them;
everything else is elementwise work, reductions and the like.

All calls of a flash kernel in a dense cell's step have one shape: q (micro
batch, seq, heads, head_dim), k and v with the KV heads, causal from row 0.
The forward kernel runs once a layer and micro batch, and once more where
the layer is recomputed (remat); each backward kernel once a layer and
micro batch.
"""
from __future__ import annotations

from harness import flops

FLASH = {"fwd": "flash_fwd_kernel", "dq": "flash_bwd_dq_kernel", "dkv": "flash_bwd_dkv_kernel"}
GEMM_MARKS = ("gemm", "Gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_")
COPY_MARKS = ("Memcpy", "Memset")


def is_flash(name: str) -> bool:
    return any(k in name for k in FLASH.values())


def is_gemm(name: str) -> bool:
    return any(m in name for m in GEMM_MARKS)


def is_elementwise(name: str) -> bool:
    return not (is_flash(name) or is_gemm(name) or name.startswith(COPY_MARKS))


def elementwise_ms_per_step(ctx) -> float:
    """Device ms a traced step of the elementwise kernels of a one-job cell;
    None where the trace holds none."""
    t = ctx["spec"]["traffic_data"]
    durs = [dur for name, _, dur in ctx["trace"]["ops"] if is_elementwise(name)]
    return sum(durs) / 1e3 / t["trace_steps"] if durs and t["jobs"] == 1 else None


def calls(ops: list, kernel: str) -> list:
    """Durations (µs) of the trace's calls of the flash kernel ``kernel``."""
    return [dur for name, _, dur in ops if FLASH[kernel] in name]


def calls_per_step(ctx, kernel: str) -> int:
    m, t = ctx["spec"]["config_data"]["model"], ctx["spec"]["traffic_data"]
    remat = ctx["spec"]["config_data"]["program"]["fields"].get("remat", False)
    per_layer = (2 if remat else 1) if kernel == "fwd" else 1
    return m["layers"] * t["grad_accum"] * per_layer


def roofline(ctx, names) -> float:
    """100 x summed least time / summed device time of the calls of the
    kernels ``names``, or None where the calls are not the cell's."""
    m, t = ctx["spec"]["config_data"]["model"], ctx["spec"]["traffic_data"]
    if m["family"] != "dense" or t["jobs"] != 1:
        return None
    least = busy = 0.0
    for kernel in names:
        durs = calls(ctx["trace"]["ops"], kernel)
        if not durs or len(durs) != calls_per_step(ctx, kernel) * t["trace_steps"]:
            return None
        ops, nbytes = flops.flash_call(kernel, t["batch"] // t["grad_accum"], m["heads"], m["kv_heads"],
                                       t["seq"], m["head_dim"])
        least += len(durs) * flops.least_time(ops, nbytes)
        busy += sum(durs) / 1e6
    return 100.0 * least / busy
