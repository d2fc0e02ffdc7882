"""flash_fwd_roofline: the flash forward kernel's (K1) least time over its
device time, summed over its calls in the traced window of the long-context
cell, in %. A call's least time is the larger of its operations over the
bf16 peak and its bytes over the bandwidth, from the cell's shapes
(``harness.flops.flash_call``). Returns nothing where the trace holds no
call, or not the calls that the cell's steps make (``harness.kernels``),
whose shapes it would not know."""
from harness import kernels


def read(ctx):
    return kernels.roofline(ctx, ("fwd",))
