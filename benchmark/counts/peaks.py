"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
data sheet, dense rates without sparsity, at the 700 W limit)."""

PEAK_BF16_OPS_S = 989e12  # bf16 and fp16 on the tensor cores
PEAK_TF32_OPS_S = 494.7e12  # TF32 on the tensor cores
PEAK_F32_OPS_S = 67e12  # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # HBM3
SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column, dense"


def roofline_s(n_ops: float, n_bytes: float, ops_per_s: float) -> float:
    """The least time for this work: the larger of its operations at
    ``ops_per_s`` and its bytes at the memory's rate."""
    return max(n_ops / ops_per_s, n_bytes / PEAK_BYTES_S)
