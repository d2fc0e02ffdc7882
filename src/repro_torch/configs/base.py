"""Unified model configuration across all assigned architecture families."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN spec (deepseek-moe / olmoe style)."""

    n_experts: int
    top_k: int
    d_expert: int  # hidden width of each routed expert
    n_shared: int = 0  # fused shared-expert count (deepseek fine-grained)
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # expert-capacity factor; reduced configs set it high so no token is
    # ever dropped and decode == teacher-forced forward exactly
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """State-space / linear-attention spec (rwkv6, mamba2)."""

    kind: str  # 'rwkv6' | 'mamba2'
    state_dim: int = 64  # N (mamba2) or head_dim (rwkv6 K)
    head_dim: int = 64
    d_conv: int = 4  # mamba2 short conv
    expand: int = 2  # mamba2 inner expansion
    chunk: int = 64  # chunked-scan block length
    lora_rank: int = 64  # rwkv6 data-dependent decay LoRA rank


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config drives every family; unused fields stay at their defaults."""

    name: str
    family: str  # dense|moe|rwkv|hybrid|encdec|vlm|resnet
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # hybrid (zamba2): a single *shared* attention block applied before every
    # ``attn_every``-th ssm layer.
    attn_every: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    n_frames: int = 1500  # stub audio frontend: precomputed frame embeddings
    # vlm (llava): stub patch embeddings prepended to the token stream
    n_patches: int = 0
    # enc-dec decoder positional table size (whisper)
    max_dec_pos: int = 32_768
    # resnet (paper workload trio)
    img_size: int = 0
    n_classes: int = 0
    stages: Tuple[int, ...] = ()
    base_width: int = 64
    # numerics / runtime
    remat: bool = True
    attn_block_q: int = 512  # xla-flash blocking
    attn_block_k: int = 1024
    logit_softcap: float = 0.0
    label_smoothing: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a TP-shardable multiple (Megatron-style).

        Logical vocab is unchanged; pad logits are masked to -inf in
        ``logits_fn`` and synthetic data never emits pad ids.
        """
        mult = 16
        return -(-self.vocab // mult) * mult

    @property
    def q_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 256),
            head_dim=16 if self.resolved_head_dim > 16 else self.resolved_head_dim,
            enc_layers=min(self.enc_layers, 2),
            n_frames=min(self.n_frames, 8) if self.enc_layers else self.n_frames,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            attn_every=2 if self.attn_every else 0,
            attn_block_q=8,
            attn_block_k=8,
            remat=False,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2), d_expert=32,
                n_shared=min(self.moe.n_shared, 1), capacity_factor=8.0,
            )
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, state_dim=8, head_dim=8, chunk=8, lora_rank=8,
            )
        if self.family == "resnet":
            small.update(
                img_size=min(self.img_size, 32),
                n_classes=min(self.n_classes, 10),
                stages=tuple(min(s, 2) for s in self.stages),
                base_width=8,
            )
        if self.enc_layers:
            small["max_dec_pos"] = 128
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# shape suites (assigned input shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeSuite("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSuite("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSuite("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSuite("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSuite, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# Families with sub-quadratic sequence mixing may run long_500k.
SUBQUADRATIC_FAMILIES = ("rwkv", "hybrid")


def shape_applicable(cfg: ModelConfig, suite: ShapeSuite) -> Tuple[bool, str]:
    """(applicable?, reason-if-not). Encodes the DESIGN.md §4 skip table."""
    if suite.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: O(S^2) at 500k — skipped per DESIGN.md"
    if suite.kind == "decode" and cfg.family == "resnet":
        return False, "CNN classifier has no autoregressive decode"
    return True, ""
