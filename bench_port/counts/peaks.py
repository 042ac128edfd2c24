"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates without sparsity). A card set to a lower power limit
reaches less: every run prints the limit beside its numbers."""

BYTES_PER_S = 3.35e12  # HBM3
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
BF16_FLOPS = 989e12  # bfloat16 on the tensor cores

# the dense tensor-core peak of the precision a configuration states
# ("float32" means PyTorch's default: TF32 convolutions)
BY_PRECISION = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS}


def least_seconds(nbytes: float, flops: float, tc_flops: float = 0.0) -> float:
    """The least time of some work: the larger of its bytes over the memory
    rate and its operations' time, `tc_flops` (a matrix product) at the TF32
    tensor-core rate plus `flops` (elementwise and compare work) at the f32 rate."""
    return max(nbytes / BYTES_PER_S, tc_flops / TF32_FLOPS + flops / F32_FLOPS)
