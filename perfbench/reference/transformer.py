"""A dense decoder-only transformer with grouped-query attention, in plain
PyTorch and float32: the reference of the dense cells.

The model as the configuration's ``model`` section states it: token
embedding; ``layers`` pre-norm blocks of RMSNorm (eps ``rms_eps``, a gain a
channel), causal attention of ``heads`` query heads over ``kv_heads`` key and
value heads of ``head_dim`` with rotary embeddings (split halves, base
``rope_theta``) on q and k and a 1/sqrt(head_dim) scale, and a SwiGLU MLP of
``d_ff``; a final RMSNorm; logits from the embedding table (tied head),
columns past ``vocab`` masked; the loss is the mean next-token cross entropy
plus ``z_loss`` times the mean squared log-partition.

The parameters are the tree the benchmark made (``harness.weights``): the
layers' leaves stacked on a leading dim, kernels stored (in, out). Every
product is ``rnd(a) @ rnd(b)`` in f32: ``rnd`` is the identity for the
reference and rounds to a lower precision for the control. Each layer is
recomputed in the backward pass (``torch.utils.checkpoint``) and attention
runs a block of query rows at a time with its own backward, so that the
whole model fits on one card at the cells' sizes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

#: query rows of one attention block, and rows of one block of the loss
ATTN_ROWS = 4096
LOSS_ROWS = 4096


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """(B, S, heads, D), positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class CausalAttention(torch.autograd.Function):
    """Causal softmax attention of q (B, KVH, G, S, D) over k, v (B, KVH, S,
    D), exact in f32, a block of query rows at a time; the backward
    recomputes each block's probabilities from the saved log-partition."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, KVH, G, S, D = q.shape
        scale = D ** -0.5
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:-1], dtype=q.dtype, device=q.device)
        for b in range(B):
            for h in range(KVH):
                for i0 in range(0, S, ATTN_ROWS):
                    i1 = min(S, i0 + ATTN_ROWS)
                    s = _scores(q[b, h, :, i0:i1], k[b, h, :i1], scale, i0)
                    m = s.amax(-1, keepdim=True)
                    p = s.sub_(m).exp_()
                    den = p.sum(-1, keepdim=True)
                    o[b, h, :, i0:i1] = torch.matmul(p, v[b, h, :i1]).div_(den)
                    lse[b, h, :, i0:i1] = (m + den.log())[..., 0]
                    del s, p
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, KVH, G, S, D = q.shape
        scale = D ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (do * o).sum(-1)
        for b in range(B):
            for h in range(KVH):
                for i0 in range(0, S, ATTN_ROWS):
                    i1 = min(S, i0 + ATTN_ROWS)
                    qb, dob = q[b, h, :, i0:i1], do[b, h, :, i0:i1]
                    p = _scores(qb, k[b, h, :i1], scale, i0).sub_(lse[b, h, :, i0:i1, None]).exp_()
                    dv[b, h, :i1] += torch.matmul(p.transpose(1, 2), dob).sum(0)
                    ds = torch.matmul(dob, v[b, h, :i1].transpose(0, 1)).sub_(delta[b, h, :, i0:i1, None])
                    ds.mul_(p).mul_(scale)
                    del p
                    dq[b, h, :, i0:i1] = torch.matmul(ds, k[b, h, :i1])
                    dk[b, h, :i1] += torch.matmul(ds.transpose(1, 2), qb).sum(0)
                    del ds
        return dq, dk, dv


def _scores(qb, kb, scale, i0):
    """(G, n, i1) scaled scores of the query rows i0.. over keys 0..i1-1, the
    keys after each row masked."""
    s = torch.matmul(qb, kb.transpose(0, 1)).mul_(scale)
    n = qb.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=s.device).triu_(1)
    s[:, :, i0:].masked_fill_(mask, float("-inf"))
    return s


def block(model, rnd, h, an, wq, wk, wv, wo, mn, wg, wu, wd):
    B, S, _ = h.shape
    H, KVH, D = model["heads"], model["kv_heads"], model["head_dim"]
    x = rmsnorm(h, an, model["rms_eps"])
    q = rope((rnd(x) @ rnd(wq)).view(B, S, H, D), model["rope_theta"])
    k = rope((rnd(x) @ rnd(wk)).view(B, S, KVH, D), model["rope_theta"])
    v = (rnd(x) @ rnd(wv)).view(B, S, KVH, D)
    q5 = rnd(q).view(B, S, KVH, H // KVH, D).permute(0, 2, 3, 1, 4).contiguous()
    o = CausalAttention.apply(q5, rnd(k).permute(0, 2, 1, 3).contiguous(), rnd(v).permute(0, 2, 1, 3).contiguous())
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * D)
    h = h + rnd(o) @ rnd(wo)
    x = rmsnorm(h, mn, model["rms_eps"])
    a = F.silu(rnd(x) @ rnd(wg)) * (rnd(x) @ rnd(wu))
    return h + rnd(a) @ rnd(wd)


LAYER_LEAVES = (("attn_norm", "scale"), ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                ("mlp_norm", "scale"), ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _loss_rows(model, rnd, h, table, labels):
    """The sum over these rows of cross entropy plus z_loss x lse^2."""
    logits = rnd(h) @ rnd(table).transpose(0, 1)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < model["vocab"], logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[:, None])[:, 0]
    return (nll + model["z_loss"] * lse.square()).sum()


def loss(model, params, batch, rnd):
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    table = params["embed"]["table"]
    h = table[tokens]
    stacked = [params["layers"][a][b].unbind(0) for a, b in LAYER_LEAVES]
    for layer in zip(*stacked):
        h = ckpt.checkpoint(block, model, rnd, h, *layer, use_reentrant=False)
    h = rmsnorm(h, params["final_norm"]["scale"], model["rms_eps"])
    rows, flat_labels = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
    total = 0.0
    for r0 in range(0, rows.shape[0], LOSS_ROWS):
        r1 = r0 + LOSS_ROWS
        total = total + ckpt.checkpoint(_loss_rows, model, rnd, rows[r0:r1], table, flat_labels[r0:r1],
                                        use_reentrant=False)
    return total / rows.shape[0]
