"""The count functions against hand counts at small shapes: explicit loops
that tally each multiply-add and each byte read or written."""

import math

import numpy as np
import pytest

from counts import element_apply, peaks, step_flops, synth_bwd, synth_fwd


def loop_synth(A, M, T, backward: bool):
    """Walk the mode sum: one multiply-add per (row, mode, sample) forward,
    three backward (the amplitude, damping and frequency sums)."""
    madds = sum(1 for a in range(A) for m in range(M) for t in range(T))
    tables = 3 * A * M * 4
    signal = A * T * 4
    if backward:
        return 2 * 3 * madds, tables + signal + tables  # read tables and g, write grads
    return 2 * madds, tables + signal


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 5), (3, 16, 40)])
def test_synthesis_counts(shape):
    assert synth_fwd.count(*shape) == loop_synth(*shape, backward=False)
    assert synth_bwd.count(*shape) == loop_synth(*shape, backward=True)


@pytest.mark.parametrize("order", [1, 2])
def test_element_apply_counts(order):
    import torch

    from reference.mesh import make_mesh

    verts, tets = make_mesh({"kind": "cube", "cells": 1, "size": 1.0}, order)
    E, N = tets.shape
    V, cols = len(verts), 3
    n3 = 3 * N
    # K X: per element, per row of the block, per column, n3 multiply-adds
    madds = 0
    for e in range(E):
        for i in range(n3):
            for c in range(cols):
                madds += n3
    blocks = 2 * torch.zeros(E, n3, n3, dtype=torch.float32).nbytes  # k_mu, k_lam
    x = torch.zeros(3 * V, cols, dtype=torch.float32).nbytes
    nbytes = blocks + 2 * x + torch.as_tensor(tets).nbytes
    assert element_apply.count(E, N, cols, V) == (2 * madds, nbytes)
    # M X: the (N, N) reference block on each element's (N, 3c) slab
    m_madds = E * N * N * 3 * cols
    m_bytes = 4 * E + 4 * N * N + 2 * x + torch.as_tensor(tets).nbytes
    assert element_apply.mass_count(E, N, cols, V) == (2 * m_madds, m_bytes)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(peaks.F32_FLOPS, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, peaks.HBM_BYTES * 2) == pytest.approx(2.0)
    f, b = synth_fwd.count(16, 16, 8000)
    assert peaks.bound_s(f, b) == pytest.approx(b / peaks.HBM_BYTES)  # bytes bound it


DIMS = {"B": 2, "M": 2, "k": 3, "T": 64, "F": 4, "n_ffts": [16, 8],
        "E": 6, "nodes": 4, "V": 8}


def test_lobpcg_iteration_by_hand():
    d = DIMS
    n, k, c = 24, 3, 9
    apply_k = 2 * 6 * 12 * 12 * (4 * k)
    apply_m = 2 * 6 * 4 * 4 * 3 * (4 * k)
    two_pass = 2 * (2 * n * c * c + 2 * (2 * n * c * c))  # Gram and two rotations, twice
    ritz_gram = 2 * n * c * c
    xp = 2 * (2 * n * c * k)  # X = S Zm, P = S Zp
    resid = 8 * n * k
    small = 2 * (c ** 3 / 3 + c ** 3) + 9 * c ** 3
    hand = apply_k + apply_m + two_pass + ritz_gram + xp + resid + small
    assert step_flops.lobpcg_iteration(d) == pytest.approx(hand)


def test_step_by_hand():
    d = DIMS
    B, M, T, F = 2, 2, 64, 4
    hand = 12 * B * 3 + 2 * B * M * T + 6 * B * M * T
    nfft = 128  # the power of two past T + F - 1 = 67
    fft = lambda n: 2.5 * n * math.log2(n)
    hand += 4 * B * fft(nfft) + fft(nfft) + 2 * 6 * B * (nfft // 2 + 1)
    for n in (16, 8):
        frames, bins = T // (n // 4) + 1, n // 2 + 1
        hand += 2 * B * frames * (n + fft(n) + 3 * bins) + 40 * B * bins * frames
    hand += 12 * B * 32
    assert step_flops.step(d) == pytest.approx(hand)


def test_window_adds_steps_and_refreshes():
    d = DIMS
    its = [[2, 3], [1, 1]]
    w = step_flops.window(d, 30, its)
    assert w == pytest.approx(30 * step_flops.step(d) + sum(step_flops.refresh(d, i) for i in its))
    assert step_flops.refresh(d, [2, 3]) > step_flops.refresh(d, [1, 1]) > 0
    assert np.isfinite(w)
