"""One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

#: HBM3 bytes a second
BYTES_S = 3.35e12
#: bf16 and fp16 on the tensor cores
BF16_FLOPS = 989e12
#: TF32 on the tensor cores; a 3xTF32 fp32 product takes three of them
TF32_FLOPS = 495e12
#: fp32 outside the tensor cores (FFMA)
FP32_FLOPS = 67e12


def product_rate(dtype_name: str) -> float:
    """The peak of a product whose inputs are of ``dtype_name``: bf16 and
    fp16 on the tensor cores; fp32 as three TF32 products (the port's fp32
    attention route)."""
    if dtype_name in ("bfloat16", "float16"):
        return BF16_FLOPS
    return TF32_FLOPS / 3


def bound_s(flops: float, nbytes: float, rate: float) -> float:
    """The least seconds the card could take: the larger of the
    operations at ``rate`` and the bytes at the HBM's rate."""
    return max(flops / rate, nbytes / BYTES_S)
