"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit); every share is stated against these,
with the card's power limit beside it."""

BF16_FLOPS = 989e12   # tensor cores, bfloat16 and float16
FP32_OPS = 67e12      # float32 and int32 lanes outside the tensor cores
HBM_BYTES = 3.35e12   # bytes a second of HBM3


def least_s(ops: float, moved: float, peak_ops: float = BF16_FLOPS) -> float:
    """The least time of a piece of work: the larger of its operations at
    the peak rate and its bytes at the memory bandwidth."""
    return max(ops / peak_ops, moved / HBM_BYTES)
