"""The oscillator-bank synthesis, (A, M) frequencies, dampings and
amplitudes -> (A, T) float32 signals:

    out[a, t] = sum_m amp[a, m] exp(-d[a, m] (t+1)/sr) sin(2 pi f[a, m] (t+1)/sr)

Operations: the mode sum, one multiply-add per (row, mode, sample).
Bytes: the three (A, M) tables read once, the (A, T) signal written once.
"""


def count(A: int, M: int, T: int) -> tuple:
    """(flops, bytes)."""
    return 2 * A * M * T, 4 * (3 * A * M + A * T)
