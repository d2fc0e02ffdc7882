"""whisper-base [audio enc-dec] — conv frontend is a STUB: input_specs
provides precomputed frame embeddings (B, 1500, d); the 6L+6L backbone is
real (arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    n_frames=1500,
    tie_embeddings=True,
    max_dec_pos=32_768,  # shape-faithful to decode_32k (real model caps at 448)
)
