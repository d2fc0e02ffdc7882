"""elementwise_ms_per_step: device ms a step of kernels that are neither the
flash kernels nor library matrix products nor copies (``harness.kernels``):
the elementwise PyTorch of the model, the loss and AdamW; over the traced
steps of the long-context cell."""
from harness import kernels


def read(ctx):
    return kernels.elementwise_ms_per_step(ctx)
