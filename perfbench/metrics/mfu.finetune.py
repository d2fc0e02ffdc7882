"""mfu.finetune: as ``mfu.train``, in the fine-tuning cell."""
from harness import flops


def read(ctx):
    return flops.dense_mfu(ctx)
