"""rwkv6-1.6b [ssm/linear-attn] — Finch, data-dependent decay
(arXiv:2404.05892). Attention-free: runs long_500k."""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,      # wkv heads = d_model / head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    norm="layernorm",
    ssm=SSMSpec(kind="rwkv6", state_dim=64, head_dim=64, chunk=64, lora_rank=64),
)
