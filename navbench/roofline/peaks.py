"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): HBM3 bandwidth and float32 outside the tensor cores. A run
prints the card's ``power.limit`` beside every share it reports."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes over bandwidth or float
    operations over the float32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
