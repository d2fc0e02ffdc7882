"""mfu.resnet: the jobs' model FLOPs a second over the card's f32 peak (the
convolutions run in f32, TF32 off), in %: three times the forward's
convolution and head FLOPs an image (``harness.flops``) at the window's
images/s of all jobs together. ResNet cells only."""
from harness import flops


def read(ctx):
    m = ctx["spec"]["config_data"]["model"]
    if m["family"] != "resnet_v2":
        return None
    return 100.0 * ctx["run"]["rate"] * flops.resnet_train_flops_per_image(m) / flops.PEAK_F32
