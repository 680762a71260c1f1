"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), frozen here so that the yardstick does not move with the program."""

PEAK_FLOPS_BF16 = 989e12          # tensor cores, bf16 / fp16
PEAK_FLOPS_F32 = 67e12            # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12

PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of a call: the larger of its bytes over the HBM
    bandwidth and its operations over the peak of ``dtype``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
