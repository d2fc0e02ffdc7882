"""Unified model API: one ``Model`` facade per architecture family.

Every family exposes the same surface so the runtime never branches on
architecture:

  init(gen, device)               -> params (nested dict of tensors)
  loss(params, batch, plan)       -> (scalar, metrics)
  prefill(params, batch, plan)    -> (last_logits, cache)
  decode(params, batch, cache, pos, plan) -> (logits, cache)
  cache_spec(batch, seq)          -> dict of (shape, dtype)
  input_specs(suite)              -> dict[str, (shape, dtype)]

The port builds every family of the reference: ``dense`` and ``vlm``
(transformer.py), ``moe`` (moe.py), ``rwkv`` (rwkv6.py), ``hybrid`` and its
alias ``ssm`` (mamba2.py), ``encdec`` (encdec.py) and ``resnet``
(resnet.py). A family it does not know raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import losses
from repro_torch.models import transformer as tfm
from repro_torch.sharding.plan import ShardingPlan

Params = Dict[str, Any]
Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_spec: Callable[[int, int], Any]
    input_specs: Callable[[ShapeSuite], Dict[str, Spec]]

    def param_count(self, params: Optional[Params] = None) -> int:
        from repro_torch.models.module import param_count

        if params is None:
            # shapes only: the meta device allocates nothing
            params = self.init(torch.Generator(device="cpu"), "meta")
        return param_count(params)


# ---------------------------------------------------------------------------
# shared input-spec builders
# ---------------------------------------------------------------------------


def _lm_train_specs(cfg: ModelConfig, suite: ShapeSuite) -> Dict[str, Spec]:
    B, S = suite.global_batch, suite.seq_len
    specs: Dict[str, Spec] = {
        "tokens": ((B, S), torch.int32),
        "labels": ((B, S), torch.int32),
    }
    if cfg.n_patches:
        specs["patches"] = ((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
    if cfg.enc_layers:
        specs["frames"] = ((B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    return specs


def _lm_prefill_specs(cfg: ModelConfig, suite: ShapeSuite) -> Dict[str, Spec]:
    specs = _lm_train_specs(cfg, suite)
    specs.pop("labels")
    return specs


def _lm_decode_specs(cfg: ModelConfig, suite: ShapeSuite) -> Dict[str, Spec]:
    B = suite.global_batch
    specs: Dict[str, Spec] = {"token": ((B,), torch.int32)}
    if cfg.enc_layers:
        specs["frames"] = ((B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    return specs


def _input_specs(cfg: ModelConfig, suite: ShapeSuite) -> Dict[str, Spec]:
    if suite.kind == "train":
        return _lm_train_specs(cfg, suite)
    if suite.kind == "prefill":
        return _lm_prefill_specs(cfg, suite)
    return _lm_decode_specs(cfg, suite)


# ---------------------------------------------------------------------------
# dense / vlm families (transformer.py backbone)
# ---------------------------------------------------------------------------


def _build_dense(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator, device="cuda"):
        return tfm.init_params(cfg, gen, resolve_device(device))

    def loss(params, batch, plan: ShardingPlan):
        logits = tfm.forward(
            cfg, params, batch["tokens"], plan, patches=batch.get("patches")
        )
        return losses.softmax_cross_entropy(
            logits, batch["labels"], label_smoothing=cfg.label_smoothing
        )

    def prefill(params, batch, plan: ShardingPlan):
        return tfm.prefill(
            cfg, params, batch["tokens"], plan, patches=batch.get("patches")
        )

    def decode(params, batch, cache, pos, plan: ShardingPlan):
        return tfm.decode_step(cfg, params, batch["token"], cache, pos, plan)

    return Model(
        cfg=cfg,
        init=init,
        loss=loss,
        prefill=prefill,
        decode=decode,
        cache_spec=lambda b, s: tfm.cache_spec(cfg, b, s),
        input_specs=lambda suite: _input_specs(cfg, suite),
    )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BUILDERS: Dict[str, Callable[[ModelConfig], Model]] = {}


def register_family(name: str):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


register_family("dense")(_build_dense)
register_family("vlm")(_build_dense)  # llava backbone = dense + patch stub


def build_model(cfg: ModelConfig) -> Model:
    # late imports, as the reference's: these modules import this one
    if "moe" not in _BUILDERS:
        from repro_torch.models import encdec, mamba2, moe, resnet, rwkv6

        register_family("moe")(moe._build_moe)
        register_family("rwkv")(rwkv6._build_rwkv)
        register_family("hybrid")(mamba2._build_hybrid)
        register_family("ssm")(mamba2._build_hybrid)  # pure-mamba configs reuse the hybrid path
        register_family("encdec")(encdec._build_encdec)
        register_family("resnet")(resnet._build_resnet)
    if cfg.family not in _BUILDERS:
        raise KeyError(f"unknown family {cfg.family!r}")
    return _BUILDERS[cfg.family](cfg)
