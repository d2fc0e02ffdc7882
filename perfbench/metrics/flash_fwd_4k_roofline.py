"""flash_fwd_4k_roofline: as ``flash_fwd_roofline``, in the fine-tuning cell
(K1 at 4,096 tokens)."""
from harness import kernels


def read(ctx):
    return kernels.roofline(ctx, ("fwd",))
