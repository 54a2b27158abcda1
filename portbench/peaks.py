"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates,
at the full 700 W power limit): what every roofline and MFU is a share of."""

BF16_FLOPS = 989e12          # tensor cores, dense bf16
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS):
    """The least time the chip needs: the larger of the operations at the
    peak rate and the bytes at the memory rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
