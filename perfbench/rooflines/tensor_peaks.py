"""Data-sheet peak of one NVIDIA H100 SXM's tensor cores in bf16 (dense, no
sparsity), at the full 700 W power limit; the memory rate and the fp32
rate are in ``peaks.py``."""

BF16_OPS_PER_S = 989.4e12
