"""The synthesis' backward, the (A, T) cotangent g -> the gradients of the
three (A, M) tables:

    grad_amp[a, m] = sum_t g e s,   grad_d = -amp sum_t g e s t,
    grad_f = 2 pi amp sum_t g e c t      (e the envelope, s, c sin and cos)

Operations: three multiply-adds per (row, mode, sample).  Bytes: the
three tables and g read once, the three gradients written once.
"""


def count(A: int, M: int, T: int) -> tuple:
    """(flops, bytes)."""
    return 6 * A * M * T, 4 * (6 * A * M + A * T)
