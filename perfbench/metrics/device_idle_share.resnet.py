"""device_idle_share.resnet: the share of the traced window in which no job's
operation ran on the card, in %, in a ResNet cell (the union of every job's
device operations: one context runs at a time)."""
from harness import trace


def read(ctx):
    return trace.idle_share(ctx, "resnet_v2")
