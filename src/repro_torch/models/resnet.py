"""ResNet-V2 (pre-activation), the paper's workload trio (PyTorch twin of
``repro.models.resnet``).

resnet_small  = ResNet26-V2  on CIFAR-10-shaped data   (32x32,  10 classes)
resnet_medium = ResNet50-V2  on ImageNet64-shaped data  (64x64,  1000 classes)
resnet_large  = ResNet152-V2 on ImageNet-shaped data    (224x224, 1000 classes)

The parameter tree is the reference's, leaf for leaf: conv weights HWIO
(kh, kw, cin, cout), BatchNorm ``scale`` and ``bias``, the head's (in, out)
matrix, the blocks a list. So ``convert.from_jax_params`` carries a reference
tree across unchanged, and checkpoints are the reference's. Activations are
NHWC, as in the reference. A convolution hands ``F.conv2d`` the permuted view
(N, C, H, W) of an NHWC tensor, which is channels_last in memory, and the
weight's view (cout, cin, kh, kw): no activation is copied to change layout.

Where the two frameworks differ, this module follows the reference:

  * ``padding="SAME"`` is XLA's, which is asymmetric where the total padding
    is odd (a 3x3 stride-2 convolution of an even size pads (0, 1), the 7x7
    stride-2 stem of 224 pads (2, 3)). ``same_pads`` reckons it as XLA does
    and the odd cases are padded by ``F.pad`` (with -inf for the max-pool,
    the reference's ``reduce_window`` init), never by a symmetric
    ``padding=k // 2``;
  * BatchNorm uses batch statistics with the population variance (ddof 0),
    in f32, cast back to the input's type;
  * the head is a dense layer computed in f32.

Everything computes in f32, or in float64 where the caller hands it float64
images and weights (a check against a float64 run). Convolutions run on
cuDNN; whether it may round their operands to TF32 is the caller's setting
(``torch.backends.cudnn.allow_tf32``). ``launch/train.py`` turns it off, so
that the card computes what the reference computes in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import module as nn
from repro_torch.models.model_api import Model
from repro_torch.sharding import dist
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` for one spatial dim:
    out = ceil(size / stride), total = max((out - 1) * stride + k - size, 0),
    low = total // 2, the rest high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _compute(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the compute type: f32, or float64 where ``x`` is float64."""
    return x if x.dtype == torch.float64 else x.float()


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """NHWC ``x`` padded on H and W as ``"SAME"`` pads a k x k window."""
    (hl, hh), (wl, wh) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    return F.pad(x, (0, 0, wl, wh, hl, hh), value=value)


def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int, device,
              dtype=torch.float32) -> Params:
    std = (2.0 / (kh * kw * cin)) ** 0.5  # He init
    return {"w": nn.trunc_normal(gen, (kh, kw, cin, cout), std, dtype, device)}


def _on_rows(fn, x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """``fn(x, *weights)``; where ``x`` is a DTensor, on each rank's own
    images, the weights whole, their gradients summed over the ranks that
    split the batch (``dist.on_shards``): DTensor's convolution rule
    (``torch.distributed.tensor._tp_conv``) splits the input's last spatial
    dim only, and it has no rule for a max-pool."""
    return dist.on_shards(lambda *a: (fn(*a),), x, [(x, {0: 0})] + [(w, {}) for w in weights], [{0: 0}])[0]


def conv_apply(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with the HWIO kernel ``p["w"]``, ``"SAME"``
    padding, NHWC out. Symmetric padding goes to the convolution itself, an
    asymmetric one to ``F.pad`` first."""
    return _on_rows(lambda xl, w: _conv(xl, w, stride), x, p["w"])


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    w = w.to(x.dtype)
    k = w.shape[0]
    (hl, hh), (wl, wh) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    if (hl, wl) == (hh, wh):
        padding = (hl, wl)
    else:
        x, padding = _pad_same(x, k, stride), 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def bn_init(c: int, device) -> Params:
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def bn_apply(p: Params, x: torch.Tensor, plan: Optional[ShardingPlan] = None, eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics over (N, H, W), population variance, in f32. Where
    the batch is split over ranks the statistics are the whole batch's, its
    sums over the ranks: on a DTensor (the baseline and sp steps) a sum over
    the sharded batch dim is a partial sum, made whole (``dist.reduced``);
    where each rank holds plain rows of the batch (the zero step) they are
    summed by ``plan.batch_sum``. A DTensor step's plan has no ``batch_sum``,
    so no sum is taken twice."""
    xf = _compute(x)
    if dist.is_dtensor(xf):
        total, n = dist.reduced, xf.numel() // xf.shape[-1]
    elif plan is not None and plan.batch_sum is not None:
        total = plan.batch_sum
        n = total(torch.tensor(float(xf.numel() // xf.shape[-1]), dtype=xf.dtype, device=xf.device))
    else:
        y = F.batch_norm(xf.permute(0, 3, 1, 2), None, None, p["scale"], p["bias"], training=True, eps=eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)
    mean = total(xf.sum(dim=(0, 1, 2))) / n
    var = total((xf - mean).square().sum(dim=(0, 1, 2))) / n
    return ((xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """The reference's ``reduce_window(max, init -inf, "SAME")`` of NHWC ``x``."""

    def pool(xl):
        return F.max_pool2d(_pad_same(xl, k, stride, float("-inf")).permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)

    return _on_rows(pool, x)


def _bottleneck_init(gen, cin: int, width: int, cout: int, device) -> Params:
    p = {
        "bn1": bn_init(cin, device),
        "conv1": conv_init(gen, 1, 1, cin, width, device),
        "bn2": bn_init(width, device),
        "conv2": conv_init(gen, 3, 3, width, width, device),
        "bn3": bn_init(width, device),
        "conv3": conv_init(gen, 1, 1, width, cout, device),
    }
    if cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout, device)
    return p


def _bottleneck_apply(p: Params, x: torch.Tensor, stride: int, plan: ShardingPlan) -> torch.Tensor:
    pre = F.relu(bn_apply(p["bn1"], x, plan))
    shortcut = conv_apply(p["proj"], pre, stride) if "proj" in p else x
    if "proj" not in p and stride > 1:
        shortcut = x[:, ::stride, ::stride, :]
    h = conv_apply(p["conv1"], pre, 1)
    h = conv_apply(p["conv2"], F.relu(bn_apply(p["bn2"], h, plan)), stride)
    h = conv_apply(p["conv3"], F.relu(bn_apply(p["bn3"], h, plan)), 1)
    return shortcut + h


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    w0 = cfg.base_width
    cifar_stem = cfg.img_size <= 32
    k0 = 3 if cifar_stem else 7
    params: Params = {"stem": conv_init(gen, k0, k0, 3, w0, device)}
    cin = w0
    blocks = []
    for stage, n_blocks in enumerate(cfg.stages):
        width = w0 * (2**stage)
        cout = width * 4
        for _ in range(n_blocks):
            blocks.append(_bottleneck_init(gen, cin, width, cout, device))
            cin = cout
    params["blocks"] = blocks
    params["final_bn"] = bn_init(cin, device)
    params["head"] = nn.dense_init(gen, cin, cfg.n_classes, device=device, dtype=torch.float32)
    return params


def _block_strides(cfg: ModelConfig) -> Tuple[int, ...]:
    strides = []
    for stage, n_blocks in enumerate(cfg.stages):
        for b in range(n_blocks):
            strides.append(2 if (b == 0 and stage > 0) else 1)
    return tuple(strides)


def forward(cfg: ModelConfig, params: Params, images: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """images: (B, H, W, 3) f32 -> logits (B, n_classes) f32 (float64 for float64 images)."""
    cifar_stem = cfg.img_size <= 32
    x = conv_apply(params["stem"], _compute(images), 1 if cifar_stem else 2)
    if not cifar_stem:
        x = max_pool_same(x)
    for p, stride in zip(params["blocks"], _block_strides(cfg)):
        x = _bottleneck_apply(p, x, stride, plan)
    x = F.relu(bn_apply(params["final_bn"], x, plan))
    x = x.mean(dim=(1, 2))  # global average pool
    return nn.dense_apply(params["head"], x, compute_dtype=x.dtype)


def _image_specs(cfg: ModelConfig, suite: ShapeSuite):
    B, s = suite.global_batch, cfg.img_size
    return {"images": ((B, s, s, 3), torch.float32), "labels": ((B,), torch.int32)}


def _build_resnet(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator, device="cuda"):
        return init_params(cfg, gen, resolve_device(device))

    def loss(params, batch, plan: ShardingPlan):
        lf = _compute(forward(cfg, params, batch["images"], plan))
        labels = batch["labels"].long()
        nll = torch.logsumexp(lf, dim=-1) - dist.gather_last(lf, labels)
        ce = nll.mean()
        acc = (lf.argmax(dim=-1) == labels).float().mean()
        return ce, {"ce": ce, "accuracy": acc}

    def _no_serve(*_a, **_k):
        raise NotImplementedError("CNN classifier has no autoregressive serving path")

    return Model(
        cfg=cfg,
        init=init,
        loss=loss,
        prefill=_no_serve,
        decode=_no_serve,
        cache_spec=lambda b, s: {},
        input_specs=lambda suite: _image_specs(cfg, suite),
    )
