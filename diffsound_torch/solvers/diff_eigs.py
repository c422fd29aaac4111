"""Differentiable eigenvalues via the detached-solve Rayleigh correction.

The eigensolve itself is never differentiated.  Given converged (but
detached) eigenpairs (lambda_i, u_i) of K u = lambda M u, the corrected

    lambda~_i = lambda_i + u_i^T K u_i - lambda_i u_i^T M u_i

equals lambda_i in value (to solver accuracy) but carries the exact
first-order derivative d lambda_i = u_i^T (dK - lambda_i dM) u_i with
respect to anything the differentiable operators K, M depend on.
Counterpart of `diffsound_tpu/solvers/diff_eigs.py`.
"""

from __future__ import annotations

import math

import torch


def rayleigh_corrected_eigenvalues(k_fn, m_fn, eigenvalues, eigenvectors):
    """lambda~ (m,) differentiable through k_fn / m_fn closures.

    k_fn/m_fn: (n, m) -> (n, m) differentiable operator applications.
    eigenvalues (m,), eigenvectors (n, m): detached solver output.
    """
    U = eigenvectors.detach()
    lam = eigenvalues.detach()
    add = (U * k_fn(U)).sum(dim=0) - lam * (U * m_fn(U)).sum(dim=0)
    return lam + add


def undamped_frequencies(eigenvalues, floor: float = 1e-3):
    """f = sqrt(lambda) / 2 pi (Hz).

    The floor keeps the clamp differentiable: sqrt(max(x, 0)) has an
    infinite gradient at a clamped zero, which turns one spuriously
    negative corrected eigenvalue into NaN parameters after one optimizer
    step.  Physical eigenvalues (>= (2 pi * 20 Hz)^2 ~ 1.6e4) are far above
    the floor."""
    return torch.sqrt(torch.clamp(eigenvalues, min=floor)) / (2.0 * math.pi)
