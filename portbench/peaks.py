"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its full power limit of 700 W; a run prints the card's own limit
beside them)."""

# float32 outside the tensor cores: both hand kernels do their counted
# arithmetic (filters, rounding, Hadamard, SAD) in float32
FP32_FLOP_S = 67e12
# HBM3
HBM_BYTE_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time a launch can take: the larger of its bytes over the
    memory rate and its operations over the float32 rate."""
    return max(nbytes / HBM_BYTE_S, ops / FP32_FLOP_S)
