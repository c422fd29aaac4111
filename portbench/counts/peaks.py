"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)."""

F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # HBM3 bytes a second


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the float32 peak and the bytes at the memory's."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
