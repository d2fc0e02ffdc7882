"""Sharding plans — the single-device subset.

Models never name mesh axes: they call ``plan.act(x, kind)`` and the plan
decides. This slice of the port runs on one device, so the only plan is the
null plan whose ``act`` returns its input. Meshes, parameter partitioning and
the zero/sp/serve variants come with the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite


@dataclasses.dataclass
class ShardingPlan:
    mesh: Optional[Any]
    act_specs: Dict[str, Any]
    dp_axes: Tuple[str, ...]
    tp_axis: Optional[str]

    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        if self.mesh is None:
            return x
        raise NotImplementedError("sharded activations come with the multi-device slice")


def make_plan(
    cfg: ModelConfig,
    mesh: Optional[Any],
    suite: Optional[ShapeSuite] = None,
    *,
    variant: str = "baseline",
) -> ShardingPlan:
    """Build the activation-sharding plan; only ``mesh=None`` is ported."""
    if mesh is None:
        return ShardingPlan(None, {}, (), None)
    raise NotImplementedError("device meshes come with the multi-device slice")
