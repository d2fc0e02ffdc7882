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
    """
    # under a mesh the vocab dim whole on each rank: DTensor's rule for a
    # gather from a vocab-sharded tensor fails on batch-sharded labels
    lf = dist.whole_on(logits.float(), -1)
    labels = labels.long()
    lse = torch.logsumexp(lf, dim=-1)  # (B,S)
    label_logit = dist.gather_last(lf, labels)
    nll = lse - label_logit
    if label_smoothing > 0.0:
        smooth = lse - lf.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    zl = lse.square()
    acc_pred = (lf.argmax(dim=-1) == labels).float()
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
