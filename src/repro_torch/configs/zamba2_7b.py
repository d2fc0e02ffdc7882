"""zamba2-7b [hybrid] — Mamba2 backbone + one shared attention block applied
periodically (arXiv:2411.15242). Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    attn_every=27,  # 81 mamba blocks in 3 groups, shared attn before each group
    ssm=SSMSpec(kind="mamba2", state_dim=64, head_dim=64, d_conv=4, expand=2, chunk=64),
    rope_theta=10_000.0,
)
