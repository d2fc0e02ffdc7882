"""Loss functions shared across families."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import dist


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    z_loss: float = 1e-4,
    label_smoothing: float = 0.0,
    mask: Optional[torch.Tensor] = None,
):
    """Mean next-token CE over (B, S, V) logits and (B, S) int labels.

    f32 log-softmax for stability; optional z-loss regularizer (production
    stabilizer for large-vocab training) and label smoothing. Returns
    (loss, metrics-dict).

    Under a mesh whose plan shards the vocab (the reference's ``logits``
    spec), each rank works on its own f32 shard of the vocab
    (``vocab_parallel_terms``) and no rank holds a (B, S, V) tensor whole.
    """
    labels = labels.long()
    smoothing = label_smoothing > 0.0
    if dist.sharded_on(logits, -1):
        lse, label_logit, mean_logit, pred = vocab_parallel_terms(logits, labels, smoothing)
    else:
        lf = dist.whole_on(logits.float(), -1)  # a vocab "sharded" over a mesh dim of one rank
        lse = torch.logsumexp(lf, dim=-1)  # (B,S)
        label_logit = dist.gather_last(lf, labels)
        mean_logit = lf.mean(dim=-1) if smoothing else None
        pred = lf.argmax(dim=-1)
    nll = lse - label_logit
    if smoothing:
        smooth = lse - mean_logit
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    zl = lse.square()
    acc_pred = (pred == labels).float()
    if mask is None:
        loss, zterm, acc = nll.mean(), zl.mean(), acc_pred.mean()
    else:
        m = mask.float()
        denom = m.sum().clamp_min(1.0)
        loss = (nll * m).sum() / denom
        zterm = (zl * m).sum() / denom
        acc = (acc_pred * m).sum() / denom
    total = loss + z_loss * zterm
    return total, {"ce": loss, "z_loss": zterm, "accuracy": acc}


def shard_terms(lf: torch.Tensor, labels: torch.Tensor, v0: int, vocab: int, reduce, with_mean: bool):
    """The loss's per-token terms from one shard of the vocab: ``lf`` (..., Vl)
    f32, columns ``[v0, v0 + Vl)`` of ``vocab``, ``labels`` (...) global ids,
    and ``reduce(t, op)`` (op "max", or "sum" and differentiable with the
    identity as its backward) over the shards. Returns ``(lse, label logit,
    mean logit, argmax)``, each whole on every shard, the mean None unless
    ``with_mean`` (label smoothing reads it):

      * lse as a max over the shards, then a sum of exp over them;
      * the label's logit from the shard that holds it (a masked gather and a sum);
      * the mean over the vocab as a sum of the shards' sums;
      * the argmax as (value, global index) across shards, the first index
        among equal maxima, as ``torch.argmax`` breaks ties.
    """
    vl = lf.shape[-1]
    m = reduce(lf.detach().amax(dim=-1), "max")
    lse = m + torch.log(reduce(torch.exp(lf - m[..., None]).sum(dim=-1), "sum"))
    inside = (labels >= v0) & (labels < v0 + vl)
    picked = torch.gather(lf, -1, (labels - v0).clamp(0, vl - 1)[..., None])[..., 0]
    label_logit = reduce(torch.where(inside, picked, 0.0), "sum")
    mean_logit = reduce(lf.sum(dim=-1), "sum") / vocab if with_mean else None
    with torch.no_grad():
        idx = lf.argmax(dim=-1)
        best = torch.gather(lf, -1, idx[..., None])[..., 0]
        top = reduce(best, "max")
        first = torch.where(best == top, idx + v0, vocab)  # no shard's maximum: past every index
        pred = -reduce(-first, "max")
    return lse, label_logit, mean_logit, pred


def vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor, with_mean: bool):
    """``shard_terms`` on each rank's local shard of ``logits`` (a DTensor
    sharded on its vocab), its reductions over the mesh dims that split the
    vocab; the terms come back as DTensors in the logits' placements but the
    vocab's (batch and sequence as they were, replicated over the vocab's
    mesh dims). Gradients reach the local shard through autograd."""
    from torch.distributed.tensor import Replicate

    x = dist.reduced(logits)
    mesh, vdims = x.device_mesh, dist.sharded_on(x, -1)
    rows = [Replicate() if i in vdims else pl for i, pl in enumerate(x.placements)]
    v0, _ = dist.shard_rows(x, -1)

    def reduce(t, op):
        return dist.sum_over(t, mesh, vdims) if op == "sum" else dist.all_sum(t, mesh, vdims, "max")

    terms = shard_terms(x.to_local().float(), dist.to_local_as(labels, mesh, rows), v0, x.shape[-1], reduce,
                        with_mean)
    return tuple(None if t is None else dist.from_local(t, mesh, rows) for t in terms)
