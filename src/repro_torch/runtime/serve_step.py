"""Serving-step builders: batched prefill and single-token decode against a
KV cache, and the eager greedy loop that joins them.

Single device only: the ``jit_*`` and ``*_shardings`` builders of the
reference wait for the multi-device slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.model_api import Model
from repro_torch.sharding.plan import ShardingPlan


def build_prefill(model: Model, plan: ShardingPlan):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, plan)

    return prefill_step


def build_decode(model: Model, plan: ShardingPlan, pos: int):
    """One-token decode step at static cache position ``pos``."""

    @torch.no_grad()
    def decode_step(params, batch, cache):
        return model.decode(params, batch, cache, pos, plan)

    return decode_step


def pad_cache(cache: Dict[str, Any], extra: int) -> Dict[str, Any]:
    """Grow the self-attention KV seq dim by ``extra`` slots after prefill.

    Returns new tensors (one copy of the cache); the input is left as it was.
    """

    def pad(name: str, leaf):
        if isinstance(leaf, dict):
            return {k: pad(k, v) for k, v in leaf.items()}
        if name in ("k", "v", "attn_k", "attn_v") and leaf.dim() == 5:
            # F.pad counts dims from the last: (D, KVH, seq)
            return F.pad(leaf, (0, 0, 0, 0, 0, extra))
        return leaf

    return {k: pad(k, v) for k, v in cache.items()}


@torch.no_grad()
def greedy_generate(
    model: Model,
    params,
    prompt: torch.Tensor,  # (B, S) int
    max_new: int,
    plan: ShardingPlan,
) -> torch.Tensor:
    """Eager greedy decoding loop; runs on the device ``prompt`` lies on."""
    B, S = prompt.shape
    last, cache = model.prefill(params, {"tokens": prompt}, plan)
    cache = pad_cache(cache, max_new)
    tokens = [torch.argmax(last, dim=-1).to(torch.int32)]
    for i in range(max_new - 1):
        logits, cache = model.decode(params, {"token": tokens[-1]}, cache, S + i, plan)
        tokens.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(tokens, dim=1)  # (B, max_new)
