"""mfu.train: the long-context training step's model FLOPs a second over
the card's bf16 peak, in %. Model FLOPs of a step: 6 per matmul weight and
token (the tied head included) and the causal attention's products, never
the recomputation (``harness.flops.dense_train_flops``); the rate is the
window's tokens/s."""
from harness import flops


def read(ctx):
    return flops.dense_mfu(ctx)
