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


def ritz_refined_eigenvalues(k_fn, m_fn, eigenvectors, num_modes=None):
    """Subspace Rayleigh-Ritz eigenvalues, differentiable through k_fn/m_fn:
    the robust replacement for the per-column Rayleigh correction when the
    detached basis comes from a warm or iterative solver.

    A per-column correction is exact only when each column of U is an
    accurate eigenvector; an iterative f32 solve leaves in-subspace rotation
    errors of order residual / gap, and thin-shell spectra are clustered.
    So the pencil is projected onto span(U) differentiably (A = U^T K U,
    B = U^T M U, k x k), the small generalized eigenproblem is solved on the
    detached (A0, B0) for a rotation Y, and the result is the Rayleigh
    quotients of the rotated basis:

        theta_i = (y_i^T A y_i) / (y_i^T B y_i),   y_i detached.

    At the evaluation point theta equals the Ritz values of span(U); the
    derivative is y_i^T (dK - theta_i dM) y_i.  No derivative flows through
    the small eigh.  With an exact basis this is
    `rayleigh_corrected_eigenvalues`.

    The Gram products are plain products in the working dtype (TF32 is off
    in this package): the JAX package needs its split-bf16 `precise_matmul`
    there only on the TPU.

    k_fn/m_fn: (n, k) -> (n, k) differentiable operators.
    eigenvectors (n, k): detached solver output.
    Returns theta (num_modes or k,) ascending.
    """
    from .lobpcg import _chol_inv_t

    U = eigenvectors.detach()
    A = U.T @ k_fn(U)
    B = U.T @ m_fn(U)
    A = 0.5 * (A + A.T)
    B = 0.5 * (B + B.T)

    A0, B0 = A.detach(), B.detach()
    # normalize the (~ identity) B0 diagonal for a well-scaled Cholesky
    d = torch.rsqrt(torch.clamp(torch.diagonal(B0), min=torch.finfo(B0.dtype).tiny))
    k = B0.shape[0]
    eye = torch.eye(k, dtype=B0.dtype, device=B0.device)
    Bn = d[:, None] * B0 * d[None, :] + (10.0 * k * torch.finfo(B0.dtype).eps) * eye
    Linv_t = _chol_inv_t(Bn)  # inv(chol(Bn)).T, upper triangular
    C0 = Linv_t.T @ (d[:, None] * A0 * d[None, :]) @ Linv_t
    _, V = torch.linalg.eigh(0.5 * (C0 + C0.T))
    Y = d[:, None] * (Linv_t @ V)  # (k, k), detached

    theta = (Y * (A @ Y)).sum(dim=0) / (Y * (B @ Y)).sum(dim=0)
    if num_modes is not None:
        theta = theta[:num_modes]
    return theta


def undamped_frequencies(eigenvalues, floor: float = 1e-3):
    """f = sqrt(lambda) / 2 pi (Hz).

    The floor keeps the clamp differentiable: sqrt(max(x, 0)) has an
    infinite gradient at a clamped zero, which turns one spuriously
    negative corrected eigenvalue into NaN parameters after one optimizer
    step.  Physical eigenvalues (>= (2 pi * 20 Hz)^2 ~ 1.6e4) are far above
    the floor."""
    return torch.sqrt(torch.clamp(eigenvalues, min=floor)) / (2.0 * math.pi)
