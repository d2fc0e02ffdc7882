"""The yardstick: the card's peaks, the model FLOPs of a training step and
the operations and bytes of the flash attention kernels' calls.

Frozen here so that a change to the program cannot move it. The peaks are
NVIDIA's data sheet for one H100 SXM5 80GB (dense, no sparsity, at the full
700 W). Model FLOPs count what the model needs, not what the program runs:
no recomputation (remat), no padding of the vocabulary.
"""
from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, tensor cores, bf16
PEAK_F32 = 67e12  # FLOP/s, f32 outside the tensor cores (TF32 off)
HBM = 3.35e12  # bytes/s


# -- dense transformer ------------------------------------------------------


def dense_matmul_params(m: dict) -> int:
    """Weights that a token multiplies by: each layer's q, k, v, o
    projections and SwiGLU MLP, and the head (the tied table counted once,
    as the head's matrix: the lookup multiplies nothing)."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * m["heads"] * hd + 2 * d * m["kv_heads"] * hd + m["heads"] * hd * d
    mlp = 3 * d * m["d_ff"]
    return m["layers"] * (attn + mlp) + m["vocab"] * d


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal sequence attends: seq (seq + 1) / 2."""
    return seq * (seq + 1) // 2


def dense_train_flops(m: dict, batch: int, seq: int) -> int:
    """FLOPs of one training step (forward 1x, backward 2x) over ``batch``
    sequences of ``seq`` tokens: 6 per matmul weight and token, and the
    causal attention's q.k and p.v, 4 x head_dim a live pair and head forward."""
    tokens = batch * seq
    attn = 4 * m["head_dim"] * m["heads"] * m["layers"] * batch * causal_pairs(seq)
    return 6 * dense_matmul_params(m) * tokens + 3 * attn


def dense_mfu(ctx) -> float:
    """% of the bf16 peak that the window's tokens/s make in model FLOPs;
    None outside a dense cell."""
    m, t = ctx["spec"]["config_data"]["model"], ctx["spec"]["traffic_data"]
    if m["family"] != "dense":
        return None
    steps_per_s = ctx["run"]["rate"] / (t["batch"] * t["seq"])
    return 100.0 * steps_per_s * dense_train_flops(m, t["batch"], t["seq"]) / PEAK_BF16


# -- ResNet-V2 ----------------------------------------------------------------


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def resnet_forward_flops(m: dict) -> int:
    """Multiply-add FLOPs (2 a MAC) of one image's forward pass: every
    convolution and the head; BatchNorm, ReLU, pooling and the sums are left
    out."""
    size = m["image_size"]
    small = size <= 32
    w0 = m["base_width"]
    flops = 0

    def conv(k, cin, cout, out_hw):
        return 2 * out_hw * out_hw * k * k * cin * cout

    size = _same_out(size, 1 if small else 2)
    flops += conv(3 if small else 7, 3, w0, size)
    if not small:
        size = _same_out(size, 2)
    cin = w0
    for stage, n_blocks in enumerate(m["stages"]):
        width = w0 * 2 ** stage
        cout = 4 * width
        for j in range(n_blocks):
            stride = 2 if (j == 0 and stage > 0) else 1
            out = _same_out(size, stride)
            flops += conv(1, cin, width, size)
            flops += conv(3, width, width, out)
            flops += conv(1, width, cout, out)
            if cin != cout:
                flops += conv(1, cin, cout, out)
            cin, size = cout, out
    return flops + 2 * cin * m["classes"]


def resnet_train_flops_per_image(m: dict) -> int:
    return 3 * resnet_forward_flops(m)


# -- the flash attention kernels (K1 forward, K2 dk/dv, K3 dq) ---------------


def flash_call(kernel: str, B: int, H: int, KVH: int, S: int, D: int, elem: int = 2) -> tuple:
    """(operations, bytes) of one causal self-attention call over q (B, S, H,
    D) and k, v (B, S, KVH, D) in a ``elem``-byte type. Operations: 4 D a
    live pair for the forward (q.k, p.v), 8 D for the dk/dv kernel (q.k,
    do.v, p.do, ds.q), 6 D for the dq kernel (q.k, do.v, ds.k). Bytes: each
    input read once and each output written once; lse and delta are f32 a
    row and head."""
    pairs = B * H * causal_pairs(S)
    q = B * S * H * D * elem
    kv = B * S * KVH * D * elem
    stat = B * S * H * 4
    if kernel == "fwd":  # q, k, v -> o, lse
        return 4 * D * pairs, q + 2 * kv + q + stat
    if kernel == "dq":  # q, k, v, o, do, lse -> dq, delta
        return 6 * D * pairs, 3 * q + 2 * kv + stat + q + stat
    if kernel == "dkv":  # q, k, v, do, lse, delta -> dk, dv
        return 8 * D * pairs, 2 * q + 2 * kv + 2 * stat + 2 * kv
    raise ValueError(kernel)


def least_time(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """Seconds the card needs at least: the larger of the two bounds."""
    return max(ops / peak, nbytes / HBM)
