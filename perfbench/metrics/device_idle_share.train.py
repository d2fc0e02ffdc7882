"""device_idle_share.train: the share of the traced window in which no
operation ran on the card, in %, in the long-context cell."""
from harness import trace


def read(ctx):
    return trace.idle_share(ctx, "dense")
