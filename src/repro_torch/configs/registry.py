"""Architecture registry: ``--arch <id>`` resolution for every entry point."""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeSuite,
    shape_applicable,
)
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.resnet_trio import RESNET_LARGE, RESNET_MEDIUM, RESNET_SMALL
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

# the 10 assigned architectures
ASSIGNED: Dict[str, ModelConfig] = {
    "stablelm-12b": _stablelm,
    "qwen2-72b": _qwen2,
    "granite-3-2b": _granite,
    "llama3-8b": _llama3,
    "llava-next-34b": _llava,
    "rwkv6-1.6b": _rwkv6,
    "deepseek-moe-16b": _deepseek,
    "olmoe-1b-7b": _olmoe,
    "whisper-base": _whisper,
    "zamba2-7b": _zamba2,
}

# the paper's own workload trio (collocation study)
PAPER_WORKLOADS: Dict[str, ModelConfig] = {
    "resnet_small": RESNET_SMALL,
    "resnet_medium": RESNET_MEDIUM,
    "resnet_large": RESNET_LARGE,
}

CONFIGS: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_WORKLOADS}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def dryrun_grid() -> List[Tuple[str, str, bool, str]]:
    """The full 40-cell grid: (arch, shape, applicable, skip_reason)."""
    cells = []
    for arch, cfg in ASSIGNED.items():
        for suite in ALL_SHAPES:
            ok, why = shape_applicable(cfg, suite)
            cells.append((arch, suite.name, ok, why))
    return cells
