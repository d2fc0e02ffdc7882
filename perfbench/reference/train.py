"""The reference's training steps: plain AdamW over the plain models, in
float32 with TF32 off, from the benchmark's weights and batches.

``follow`` runs the first ``steps`` steps of a cell's job and returns what
the check compares (``harness.check``): each step's loss, each leaf's norm
of the first gradient as the optimizer takes it (after the clip), and each
leaf's norm of its change after the last step. A leaf stored in a 16-bit
type is rounded to it after every update, as the configuration keeps it;
the arithmetic stays f32.

``precision`` names what every product's operands are rounded to: ``f32``
(the reference), or the control's lower precision, ``tf32`` (10 bits of
mantissa) or ``fp8`` (e4m3 forward and e5m2 backward, a scale a tensor).
``half_batch`` trains on the first half of each batch's rows: a fault that
the check has to catch.

Imports torch and the benchmark's own inputs and weights, nothing of the
program.
"""
from __future__ import annotations

import math

import torch

from harness import feed, weights
from reference import resnet, transformer

MODELS = {"dense": transformer.loss, "resnet_v2": resnet.loss}


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF  # round to nearest even at bit 13
    return bits.view(torch.float32)


def _fp8(x, dtype):
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Round(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def rounding(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision == "tf32":
        return lambda x: _Round.apply(x, _tf32, _tf32)
    if precision == "fp8":
        return lambda x: _Round.apply(x, lambda t: _fp8(t, torch.float8_e4m3fn),
                                      lambda t: _fp8(t, torch.float8_e5m2))
    raise ValueError(f"unknown precision {precision!r}")


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr_peak`` over ``warmup_steps``, then cosine decay
    to ``lr_min`` at ``total_steps``; in f32, as the optimizer keeps it."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = opt["lr_peak"] * s / max(opt["warmup_steps"], 1)
    frac = torch.clamp((s - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0, 1.0)
    cos = opt["lr_min"] + 0.5 * (opt["lr_peak"] - opt["lr_min"]) * (1 + torch.cos(math.pi * frac))
    return float(torch.where(s < opt["warmup_steps"], warm, cos))


def device_batch(spec, seed, step, device, half_batch=False):
    out = {}
    for k, v in feed.batch(spec, seed, step).items():
        t = torch.from_numpy(v).to(device)
        out[k] = t[: t.shape[0] // 2] if half_batch else t
    return out


#: elements of one slice of a leaf in the update, to keep its temporaries small
CHUNK = 1 << 25


@torch.no_grad()
def adamw(opt, params, grads, m, v, names, stores, step):
    """One AdamW step in place; returns each leaf's norm of its clipped gradient."""
    gnorm = torch.sqrt(sum(g.norm().square() for g in grads))
    clip = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = []
    for p, g, m_, v_, name, store in zip(params, grads, m, v, names, stores):
        g = g.reshape(-1).mul_(clip)
        norms.append(float(g.norm()))
        decay = opt["weight_decay"] and name not in opt["no_decay"]
        for ps, gs, ms, vs in zip(p.view(-1).split(CHUNK), g.split(CHUNK), m_.view(-1).split(CHUNK),
                                  v_.view(-1).split(CHUNK)):
            ms.mul_(b1).add_(gs, alpha=1 - b1)
            vs.mul_(b2).addcmul_(gs, gs, value=1 - b2)
            u = (ms / b1c).div_((vs / b2c).sqrt_().add_(opt["eps"]))
            if decay:
                u.add_(ps, alpha=opt["weight_decay"])
            ps.sub_(u.mul_(lr))
            if store != torch.float32:
                ps.copy_(ps.to(store).float())
    return norms


def follow(spec, seed, layout, steps, device, precision="f32", half_batch=False):
    """{"losses": [...], "grad": {leaf: norm}, "update": {leaf: norm}}."""
    model, opt = spec["config_data"]["model"], spec["traffic_data"]["optimizer"]
    loss_fn, rnd = MODELS[model["family"]], rounding(precision)
    params = [leaf.float() for leaf in weights.leaves(layout, seed, device)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    names = [path[-1] for path, _, _ in layout]
    stores = [dtype for _, _, dtype in layout]
    keys = ["/".join(path) for path, _, _ in layout]
    out = {"losses": [], "grad": {}, "update": {}}
    for step in range(1, steps + 1):
        for p in params:
            p.requires_grad_(True)
        tree = weights.unflatten(layout, params)
        loss = loss_fn(model, tree, device_batch(spec, seed, step - 1, device, half_batch), rnd)
        grads = torch.autograd.grad(loss, params)
        out["losses"].append(float(loss.detach()))
        del tree, loss
        params = [p.detach() for p in params]
        norms = adamw(opt, params, grads, m, v, names, stores, step)
        del grads
        if step == 1:
            out["grad"] = dict(zip(keys, norms))
    del m, v
    for i, (k, p) in enumerate(zip(keys, params)):
        out["update"][k] = float((p - weights.make_leaf(layout, i, seed, device).float()).norm())
    return out
