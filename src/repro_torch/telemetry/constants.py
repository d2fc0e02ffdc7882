"""Hardware constants of the card the port runs on, for the roofline model.

Published figures of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W). A card set below
that limit runs slower under load, so a measurement is stated beside the
card's name and power limit.

The scheduling core's slice-unit budget is not here: it is a currency of the
placement algebra, not a property of this card (``core/slice_unit.py``).
"""
import torch

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, H100 SXM5 80GB: bf16/fp16 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, H100 SXM5 80GB: f32 outside the tensor cores (TF32 off)
HBM_BW = 3.35e12  # bytes/s, H100 SXM5 80GB: HBM3
# the inter-device link: H100 SXM5 80GB, NVLink 4 at 900 GB/s both ways
# together, 450 GB/s each way (the name is the roofline's, which reads it)
ICI_LINK_BW = 450e9

# the peak a step's arithmetic runs at, by the type it computes in
PEAK_FLOPS = {
    torch.bfloat16: PEAK_FLOPS_BF16,
    torch.float16: PEAK_FLOPS_BF16,
    torch.float32: PEAK_FLOPS_F32,
}

DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}
