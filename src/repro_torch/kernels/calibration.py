"""Calibration shapes and the timed kernel call of the calibration loop.

The port's home for what the reference's ``benchmarks/kernel_bench.py``
gives ``core/calib/harness.py::KernelBackend``: one small shape per kernel
family, the map from a workload arch to the family it is timed with, and
``measure_calibration_kernel``, which runs that family's kernel through
``kernels/ops.py`` (K1 flash attention, K4 decode attention or K5 the WKV6
scan on a CUDA tensor) and holds its output against ``kernels/ref.py``.

The shapes are the reference's but where the port's kernels take less:

  * head_dim 32 becomes 64 for flash and decode attention, which take head
    dims 64, 112, 128 and 160 only (``flash_attention.HEAD_DIMS``);
  * K = V = 32 becomes 64 for the WKV6 scan, which is built for heads of 64
    (``rwkv6_scan.HEAD_SIZE``);
  * the Pallas kernels' tiles (``block_q``, ``block_k``, ``chunk``) go: the
    port's kernels choose their own, and the WKV6 kernel raises on any chunk
    but 64.

Flash and decode attention take bf16 on the card (they raise on f32) and
f32 on the CPU; the WKV6 scan takes f32 on both. Families the kernels do not
cover (the ResNets have no conv kernel) are timed with flash attention as a
proxy, as in the reference.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref

#: kernel family -> the (arch-agnostic) measurement shape.
CALIBRATION_SHAPES = {
    "flash_attention": {"B": 1, "S": 128, "H": 4, "KVH": 2, "D": 64},
    "decode_attention": {"B": 4, "Smax": 256, "H": 4, "KVH": 2, "D": 64, "kv_len": 192},
    "wkv6": {"B": 1, "T": 128, "H": 4, "K": 64},
}

#: registry family (configs/registry.py ModelConfig.family) -> kernel family.
CALIBRATION_KERNELS = {
    "dense": "flash_attention",
    "vlm": "flash_attention",
    "moe": "flash_attention",
    "encdec": "flash_attention",
    "hybrid": "flash_attention",
    "resnet": "flash_attention",  # proxy: no conv kernel in-tree
    "rwkv": "wkv6",
}


def calibration_kernel_for(arch: str) -> str:
    """The kernel family the calibration harness times for ``arch``."""
    from repro_torch.configs.registry import CONFIGS

    family = getattr(CONFIGS[arch], "family", "dense")
    return CALIBRATION_KERNELS.get(family, "flash_attention")


def calibration_inputs(kernel: str, device: torch.device) -> Tuple[Callable, Callable]:
    """(run the kernel, run its plain version) on the family's inputs, drawn
    from a generator seeded with 0. The plain version gets the same values
    the kernel gets, upcast: f32 for attention, float64 for the scan."""
    if kernel not in CALIBRATION_SHAPES:
        raise KeyError(f"no calibration shape for kernel {kernel!r}")
    shp = CALIBRATION_SHAPES[kernel]
    gen = torch.Generator().manual_seed(0)
    half = torch.bfloat16 if device.type == "cuda" else torch.float32

    def randn(*shape, dtype=half):
        return torch.randn(shape, generator=gen, dtype=torch.float32).to(device=device, dtype=dtype)

    if kernel == "flash_attention":
        B, S, H, KVH, D = (shp[n] for n in ("B", "S", "H", "KVH", "D"))
        q, k, v = randn(B, S, H, D), randn(B, S, KVH, D), randn(B, S, KVH, D)
        return (lambda: ops.flash_attention(q, k, v),
                lambda: ref.mha_reference(q.float(), k.float(), v.float()))
    if kernel == "decode_attention":
        B, Smax, H, KVH, D = (shp[n] for n in ("B", "Smax", "H", "KVH", "D"))
        q, kc, vc = randn(B, H, D), randn(B, Smax, KVH, D), randn(B, Smax, KVH, D)
        # on the device once: a Python int costs the wrapper a blocking copy a call
        kv_len = torch.tensor([shp["kv_len"]], dtype=torch.int32, device=device)
        return (lambda: ops.decode_attention(q, kc, vc, kv_len=kv_len),
                lambda: ref.decode_attention_reference(q.float(), kc.float(), vc.float(), kv_len=kv_len))
    B, T, H, K = (shp[n] for n in ("B", "T", "H", "K"))
    f32 = torch.float32
    r, k, v = randn(B, T, H, K, dtype=f32), randn(B, T, H, K, dtype=f32), randn(B, T, H, K, dtype=f32)
    logw = -randn(B, T, H, K, dtype=f32).abs() - 0.05
    u, s0 = randn(H, K, dtype=f32), randn(B, H, K, K, dtype=f32)
    args = (r, k, v, logw, u, s0)
    return (lambda: ops.wkv6(*args),
            lambda: ref.wkv6_reference(*(x.double() for x in args)))


def _flat(x) -> torch.Tensor:
    parts = x if isinstance(x, tuple) else (x,)
    return torch.cat([t.reshape(-1).double() for t in parts])


def measure_calibration_kernel(
    arch: str, *, device: str = "cuda", n: int = 2, kernel: Optional[str] = None
) -> Dict:
    """Time and numerics of ``arch``'s calibration kernel.

    Returns ``{"kernel", "wall_s", "max_err_vs_ref"}``: the max abs error
    of one run against the plain version at the same inputs, then, after one
    warm-up run, the mean seconds of ``n`` timed runs. On the card the
    kernel runs and two CUDA events around the ``n`` runs time it (at these
    shapes that is mostly launch latency); on the CPU, which the caller must
    ask for, the plain versions run and ``time.perf_counter`` times them.
    ``kernel`` overrides the arch->family mapping (e.g. the serve phase's
    ``decode_attention``, which no training arch maps to).
    """
    kernel = kernel if kernel is not None else calibration_kernel_for(arch)
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"calibration kernels run on cuda or cpu, not {dev}")
    with torch.no_grad():
        run_it, oracle = calibration_inputs(kernel, dev)
        err = float((_flat(run_it()) - _flat(oracle())).abs().max())
        run_it()  # warm-up
        if dev.type == "cpu":
            t0 = time.perf_counter()
            for _ in range(n):
                run_it()
            wall = (time.perf_counter() - t0) / n
        else:
            with torch.cuda.device(dev):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(n):
                    run_it()
                end.record()
                torch.cuda.synchronize()
                wall = start.elapsed_time(end) / 1e3 / n
    return {"kernel": kernel, "wall_s": wall, "max_err_vs_ref": err}
