"""llava-next-34b [vlm] — anyres tiling frontend is a STUB: input_specs
provides precomputed patch embeddings (B, n_patches, d_model); the 60L GQA
backbone is real (hf:llava-hf/llava-v1.6 family)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_patches=576,  # one 24x24 anyres tile worth of patch embeddings
    rope_theta=5_000_000.0,
)
