"""elementwise_ms_per_step.finetune: as ``elementwise_ms_per_step``, in the
fine-tuning cell."""
from harness import kernels


def read(ctx):
    return kernels.elementwise_ms_per_step(ctx)
