"""Least time of one ``ssm_scan`` call (three launches: the state, carry
and output passes) at a Mamba2 prefill's shapes: x (B, S, H, P), b and c
(B, S, H, N) and y in bf16, the per-head decay a (B, S, H) and h_final (B,
H, N, P) in fp32, each read or written once over the memory rate, against
the recurrence's 5·N·P operations a token and head (decay, input and
readout products and sums) over the fp32 rate, whichever is larger (the
operations, at Zamba2-7B's). c counts at every head: the kernel is given
each group's C copied to its heads."""

from perfbench.rooflines.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

KERNELS = ("ssm_state_kernel", "ssm_carry_kernel", "ssm_output_kernel")
CALL = "ssm_state_kernel"  # one launch of it a call


def bound_s(b: int, s: int, h: int, n: int, p: int) -> float:
    nbytes = 2 * b * s * h * (p + n + n + p) + 4 * b * s * h + 4 * b * h * n * p
    return max(nbytes / HBM_BYTES_PER_S, 5 * b * s * h * n * p / FP32_OPS_PER_S)
