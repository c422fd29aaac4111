"""The floating-point operations of the multi-pair trainer's work, counted
from shapes and from the LOBPCG iterations each pair reports.

dims: pairs B, modes M, solved columns k (= M + rigid), samples T,
n_ffts, force frames F, tetrahedra E, nodes per tet, vertices V.

A refresh, per pair: the start (B-orthonormalize and Rayleigh-Ritz of the
k starting columns) and per LOBPCG iteration, on the 3k-column basis
S = [X, R, P]: K and M on X and on S (4k columns each), two passes of
Cholesky-QR (a Gram and two rotations each), the Ritz Gram, the X and P
updates, the (3k)^3 Cholesky, triangular inverse and eigh.  Then the
quadratic forms of the new basis (K_mu, K_lam and M on k columns).
A step: the Rayleigh correction, the synthesis and its backward, the
force convolution by FFT and its backward, the five spectrograms and
their backward, the L1 and Adam.  An FFT of length n counts
2.5 n log2 n; the backward of a linear map counts as its forward.
"""

import math

from . import element_apply, synth_bwd, synth_fwd


def _fft(n: int) -> float:
    return 2.5 * n * math.log2(n)


def _applies(d: dict, k_cols: int, m_cols: int) -> float:
    E, N, V = d["E"], d["nodes"], d["V"]
    return element_apply.count(E, N, k_cols, V)[0] + element_apply.mass_count(E, N, m_cols, V)[0]


def lobpcg_iteration(d: dict) -> float:
    """One LOBPCG iteration of one pair."""
    n, k = 3 * d["V"], d["k"]
    c = 3 * k
    grams = 2 * (3 * 2 * n * c * c) + 2 * n * c * c
    updates = 2 * 2 * n * c * k + 8 * n * k
    small = 2 * (c ** 3 / 3 + c ** 3) + 9 * c ** 3
    return _applies(d, 4 * k, 4 * k) + grams + updates + small


def refresh(d: dict, iters: list) -> float:
    """One batched refresh whose pairs took `iters` iterations each, and the
    forms of its result."""
    n, k = 3 * d["V"], d["k"]
    start = _applies(d, k, k) + 2 * (3 * 2 * n * k * k) + 2 * n * k * k + 2 * n * k * k + 9 * k ** 3
    forms = _applies(d, 2 * k, k) + 3 * 2 * n * k
    return sum(start + it * lobpcg_iteration(d) + forms for it in iters)


def step(d: dict) -> float:
    """One L1 step of all B pairs, forward and backward."""
    B, M, T, F = d["B"], d["M"], d["T"], d["F"]
    flops = 12 * B * d["k"]  # Rayleigh correction, frequencies, damping
    flops += synth_fwd.count(B, M, T)[0] + synth_bwd.count(B, M, T)[0]
    nfft = 1 << (T + F - 2).bit_length()
    flops += 4 * B * _fft(nfft) + _fft(nfft) + 2 * 6 * B * (nfft // 2 + 1)
    for n in d["n_ffts"]:
        frames = T // (n // 4) + 1
        bins = n // 2 + 1
        spec = frames * (n + _fft(n) + 3 * bins)
        flops += 2 * B * spec + 2 * 2 * 10 * B * bins * frames
    flops += 12 * B * 32  # Adam on (B, 16) + (B, 16) logits
    return flops


def window(d: dict, steps: int, refresh_iters: list) -> float:
    """All of a window: `steps` steps and one refresh per entry of
    refresh_iters (a list of per-pair iteration lists)."""
    return steps * step(d) + sum(refresh(d, its) for its in refresh_iters)
