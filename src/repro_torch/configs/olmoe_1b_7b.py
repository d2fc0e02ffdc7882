"""olmoe-1b-7b [moe] — 64 experts top-8 (arXiv:2409.02060)."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoESpec(n_experts=64, top_k=8, d_expert=1024, n_shared=0),
    rope_theta=10_000.0,
)
