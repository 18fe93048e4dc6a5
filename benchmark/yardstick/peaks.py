"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

BF16_FLOPS = 989e12  # bfloat16 on the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# the peak that prices a whole step, by the compute dtype its configuration
# states; float32 runs with TF32 off, so its products stay off the tensor cores
STEP_PEAK = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the card can take for a kernel's work: its operations
    at the dense TF32 peak or its bytes at HBM bandwidth, whichever is
    longer. The same count holds whatever implements the work."""
    return max(flop / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
