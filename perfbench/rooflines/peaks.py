"""Data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity), at the
full 700 W power limit. Frozen from the program's card checks."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
