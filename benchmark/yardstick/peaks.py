"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

BF16_FLOPS = 989e12  # bfloat16 on the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
# float32 on the tensor cores in split TF32: each operand is split into a
# TF32 high part and a TF32 remainder (gppvae_tpu_torch/csrc/hopper.cuh
# `split_rn`), and a float32 product takes three TF32 products (hi·hi,
# hi·lo, lo·hi), so the ceiling is a third of TF32's
SPLIT_TF32_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12

# the peak that prices a whole step, by the compute dtype its configuration
# states: bfloat16 on the tensor cores; float32 at split TF32's, the ceiling
# of the way the program computes float32 products to float32's accuracy
# (csrc/conv3x3.cu and csrc/factor_prep.cu split with `split_rn`,
# csrc/nll_core.cu with hopper.cuh's `split`), which float32 outside the
# tensor cores (FP32_FLOPS) lies far below
STEP_PEAK = {"bfloat16": BF16_FLOPS, "float32": SPLIT_TF32_FLOPS}


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the card can take for a kernel's work: its operations
    at the dense TF32 peak or its bytes at HBM bandwidth, whichever is
    longer. The same count holds whatever implements the work."""
    return max(flop / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
