"""device_idle_share.finetune: as ``device_idle_share.train``, in the
fine-tuning cell."""
from harness import trace


def read(ctx):
    return trace.idle_share(ctx, "dense")
