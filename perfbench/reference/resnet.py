"""ResNet-V2 (pre-activation bottlenecks) in plain PyTorch and float32: the
reference of the image cells.

The model as the configuration's ``model`` section states it (He et al.,
"Identity Mappings in Deep Residual Networks", 2016): a 7x7 stride-2 stem
and a 3x3 stride-2 max-pool (a 3x3 stride-1 stem and no pool at 32 pixels
or fewer); ``stages`` of bottlenecks (BN-ReLU-1x1, BN-ReLU-3x3, BN-ReLU-1x1
at widths 64·2^stage, out 4x that), the first of each stage strided (but
the first stage's) and projected by a 1x1 convolution of the pre-activation
where the width changes; a final BN-ReLU, global average pool and a dense
head without bias; mean cross entropy. Padding is "SAME" as XLA reckons it,
the extra row and column low-side first, then high (an odd total pads one
more at the end), the pool's with -inf. BatchNorm uses the batch's
statistics with the population variance.

Images come NHWC and kernels HWIO, as the benchmark made them; this module
computes in NCHW. Every product and convolution takes ``rnd`` of both
operands (the identity for the reference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(rnd, x, w, stride):
    """x (N, C, H, W), w HWIO."""
    k = w.shape[0]
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(rnd(x), rnd(w.permute(3, 2, 0, 1)), stride=stride)


def bn(x, p, eps):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"][:, None, None] + p["bias"][:, None, None]


def forward(model, params, images, rnd):
    eps = model["bn_eps"]
    x = images.permute(0, 3, 1, 2)
    small = model["image_size"] <= 32
    x = conv(rnd, x, params["stem"]["w"], 1 if small else 2)
    if not small:
        (hl, hh), (wl, wh) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), 3, 2)
    i = 0
    for stage, n_blocks in enumerate(model["stages"]):
        for j in range(n_blocks):
            p = params["blocks"][i]
            stride = 2 if (j == 0 and stage > 0) else 1
            pre = F.relu(bn(x, p["bn1"], eps))
            if "proj" in p:
                shortcut = conv(rnd, pre, p["proj"]["w"], stride)
            else:
                shortcut = x[:, :, ::stride, ::stride]
            h = conv(rnd, pre, p["conv1"]["w"], 1)
            h = conv(rnd, F.relu(bn(h, p["bn2"], eps)), p["conv2"]["w"], stride)
            h = conv(rnd, F.relu(bn(h, p["bn3"], eps)), p["conv3"]["w"], 1)
            x = shortcut + h
            i += 1
    x = F.relu(bn(x, params["final_bn"], eps)).mean(dim=(2, 3))
    return rnd(x) @ rnd(params["head"]["w"])


def loss(model, params, batch, rnd):
    logits = forward(model, params, batch["images"], rnd)
    labels = batch["labels"].long()
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).mean()
