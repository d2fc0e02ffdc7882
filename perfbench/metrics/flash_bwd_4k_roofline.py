"""flash_bwd_4k_roofline: as ``flash_bwd_roofline``, in the fine-tuning
cell."""
from harness import kernels


def read(ctx):
    return kernels.roofline(ctx, ("dq", "dkv"))
