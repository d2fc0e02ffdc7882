"""flash_bwd_roofline: as ``flash_fwd_roofline``, of the backward kernels
(K2 dk/dv and K3 dq) together."""
from harness import kernels


def read(ctx):
    return kernels.roofline(ctx, ("dq", "dkv"))
