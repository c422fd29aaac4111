"""Blocked generalized LOBPCG in PyTorch: the warm on-device eigensolve.

Counterpart of `diffsound_tpu/solvers/lobpcg.py`, following its CPU branch.
The search space S = [X | W | P] is (n, 3m); per iteration:

  1. residual      R = A X - B X diag(theta)
  2. precondition  W = T(R)
  3. B-orthonormalize S by two-pass Cholesky-QR with jitter
  4. Rayleigh-Ritz: eigh(S^T A S) -> m smallest; X' = S Z_m,
     P' = S (Z_m with the X-block rows zeroed)  (the "ortho" update)

The Gram matrices and the Rayleigh-Ritz eigh/Cholesky run in `gram_dtype`
(default float64) on every device: they are (3m, 3m), and FP64 on a Hopper
card costs little at that size.  The Gram products themselves are taken in
float64 too, from the working-precision basis.  The TPU-only refinements
of the JAX package (`_sym_eigh`, `_chol_unblocked`, `_tri_lower_inv`) are
not needed: `torch.linalg` is exact to working precision here.

P is seeded with random vectors from `torch.Generator(device)` so the first
iteration needs no special case.  The solver is not differentiated;
gradients flow through the Rayleigh correction in `solvers.diff_eigs`.
The loop runs on the host with one device sync per iteration (the
convergence test).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


def _chol_inv_t(G: torch.Tensor) -> torch.Tensor:
    """inv(chol(G)).T of a small SPD matrix."""
    m = G.shape[0]
    L = torch.linalg.cholesky(G)
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    return torch.linalg.solve_triangular(L, eye, upper=False).T


@dataclass
class LobpcgResult:
    eigenvalues: torch.Tensor  # (m,) ascending
    eigenvectors: torch.Tensor  # (n, m) B-orthonormal
    iterations: int
    residual_norms: torch.Tensor  # (m,) relative residuals at exit
    history: Optional[torch.Tensor] = None  # (max_iters,) max rel residual per iteration


def _gram(X: torch.Tensor, Y: torch.Tensor, gram_dtype) -> torch.Tensor:
    return X.to(gram_dtype).T @ Y.to(gram_dtype)


def _b_orthonormalize(S, BS, gram_dtype):
    """Two-pass Cholesky-QR in the B inner product.

    Returns (S', BS', Q) with S' = S Q so callers can rotate any other
    cached operator products (e.g. A S) by the same right factor."""

    def one_pass(S, BS):
        G = _gram(S, BS, gram_dtype)
        g = torch.diagonal(G)
        # Scale columns to unit B-norm first: improves conditioning of chol.
        d = torch.rsqrt(torch.clamp(g, min=torch.finfo(gram_dtype).tiny))
        G = G * d[:, None] * d[None, :]
        eps = torch.finfo(S.dtype).eps
        m = G.shape[0]
        Linv_t = _chol_inv_t(
            G + (10.0 * m * eps) * torch.eye(m, dtype=gram_dtype, device=G.device)
        ).to(S.dtype)
        dc = d.to(S.dtype)
        Q = dc[:, None] * Linv_t
        return (S * dc[None, :]) @ Linv_t, (BS * dc[None, :]) @ Linv_t, Q

    S, BS, Q1 = one_pass(S, BS)
    S, BS, Q2 = one_pass(S, BS)
    return S, BS, Q1 @ Q2


def _ritz(S, AS, gram_dtype):
    G = _gram(S, AS, gram_dtype)
    G = 0.5 * (G + G.T)
    return torch.linalg.eigh(G)


def lobpcg(
    a_fn: Callable[[torch.Tensor], torch.Tensor],
    b_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    precond_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_iters: int = 200,
    tol: float = 1e-6,
    gram_dtype: torch.dtype = torch.float64,
    seed: int = 0,
    reuse_products: bool = False,
    record_history: bool = False,
    row_mask: Optional[torch.Tensor] = None,
    num_wanted: Optional[int] = None,
) -> LobpcgResult:
    """Compute the m smallest eigenpairs of A x = lambda B x.

    a_fn/b_fn: symmetric positive (semi)definite operators, (n, k) -> (n, k).
    x0: (n, m) initial block (warm starts cut iterations sharply in training
        loops where the operator changes slowly between solves).
    precond_fn: approximate inverse of A (e.g. inverse diagonal).
    reuse_products: carry A S / B S across iterations and rotate them with
        the basis instead of re-applying the operators (the products are
        linear in S), cutting matvec columns from 5m to 2m per iteration.
        Rotation roundoff accumulates, so this is for SHORT warm-start
        refreshes (tol >= ~1e-4, <~50 iterations).  Cold high-accuracy
        solves must use the default recompute body.
    record_history: return the per-iteration max relative residual in
        `result.history` (NaN past the exit iteration).
    row_mask: (n,) 0/1 — restrict the solve to the masked row subspace (the
        random P seed and dead-residual refresh vectors are masked).
    num_wanted: converge on the first `num_wanted` columns only; the rest
        are guard vectors whose residuals never gate the exit.
    """
    with torch.no_grad():
        return _lobpcg(
            a_fn, b_fn, x0, precond_fn, max_iters, tol, gram_dtype, seed,
            reuse_products, record_history, row_mask, num_wanted,
        )


def _lobpcg(a_fn, b_fn, x0, precond_fn, max_iters, tol, gram_dtype, seed,
            reuse_products, record_history, row_mask, num_wanted):
    n, m = x0.shape
    dtype, device = x0.dtype, x0.device
    tiny = torch.finfo(dtype).tiny
    if precond_fn is None:
        precond_fn = lambda r: r
    nw = m if num_wanted is None else int(num_wanted)

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape):
        r = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return r if row_mask is None else r * row_mask[:, None]

    P = randn((n, m))

    # Initialize: B-orthonormalize X0 and take its Ritz approximation.
    X, BX, _ = _b_orthonormalize(x0, b_fn(x0), gram_dtype)
    AX = a_fn(X)
    th0, Z0 = _ritz(X, AX, gram_dtype)
    Z0 = Z0.to(dtype)
    X, AX, BX = X @ Z0, AX @ Z0, BX @ Z0
    theta = th0.to(dtype)
    AP, BP = a_fn(P), b_fn(P)

    hist = torch.full((max_iters if record_history else 1,), float("nan"), dtype=dtype)
    rel = torch.full((m,), float("inf"), dtype=dtype, device=device)
    it = 0
    while it < max_iters and float(rel[:nw].max()) > tol:
        if not reuse_products:
            AX = a_fn(X)
            BX = b_fn(X)
        R = AX - BX * theta[None, :]

        # Relative residuals, computed before the step and reported at exit.
        # The scale includes the block's largest Ritz value so near-null
        # (rigid-body) modes, where ||A x|| itself is roundoff, still count
        # as converged.
        rn = torch.linalg.vector_norm(R, dim=0)
        scale = (theta.abs() + theta.abs().max()) * torch.linalg.vector_norm(
            BX, dim=0
        ) + torch.linalg.vector_norm(AX, dim=0)
        rel = rn / torch.clamp(scale, min=tiny)
        if record_history:
            hist[it] = rel[:nw].max().cpu()

        W = precond_fn(R)
        if reuse_products:
            # Column-normalize; replace (near-)dead residual directions with
            # fresh random vectors: after convergence W -> 0 and a degenerate
            # basis otherwise corrupts the carried products.
            wn = torch.linalg.vector_norm(W, dim=0)
            fresh = randn(W.shape)
            fresh = fresh * torch.rsqrt((fresh * fresh).sum(dim=0))
            alive = wn > tiny ** 0.5
            W = torch.where(alive[None, :], W / torch.clamp(wn, min=tiny)[None, :], fresh)
            AW, BW = a_fn(W), b_fn(W)  # the only operator applications
            S = torch.cat([X, W, P], dim=1)  # (n, 3m)
            AS = torch.cat([AX, AW, AP], dim=1)
            BS = torch.cat([BX, BW, BP], dim=1)
            S, BS, Q = _b_orthonormalize(S, BS, gram_dtype)
            AS = AS @ Q
        else:
            S = torch.cat([X, W, P], dim=1)
            S, BS, _ = _b_orthonormalize(S, b_fn(S), gram_dtype)
            AS = a_fn(S)

        ritz, Z = _ritz(S, AS, gram_dtype)
        Zm = Z[:, :m].to(dtype)
        # "ortho" conjugate-direction update: drop the X-block component.
        Zp = Zm.clone()
        Zp[:m, :] = 0.0
        X, P = S @ Zm, S @ Zp
        if reuse_products:
            AX, BX, AP, BP = AS @ Zm, BS @ Zm, AS @ Zp, BS @ Zp
            if (it + 1) % 16 == 0:
                # periodic re-anchoring against accumulated rotation roundoff
                AX, BX = a_fn(X), b_fn(X)
        theta = ritz[:m].to(dtype)
        it += 1

    return LobpcgResult(
        eigenvalues=theta, eigenvectors=X, iterations=it, residual_norms=rel,
        history=hist if record_history else None,
    )


def lobpcg_solver_freq(a_fn, b_fn, x0, freq_limit: Optional[float] = None,
                       rigid_modes: int = 6, **kwargs):
    """Solve, drop the rigid-body block, and apply an optional frequency
    cutoff.  x0 (n, k + rigid_modes).  Returns (vals (<=k,), vecs (n, <=k))
    as numpy arrays without the eigenvalues above (2 pi freq_limit)^2 (a
    data-dependent width, hence host arrays)."""
    import numpy as np

    res = lobpcg(a_fn, b_fn, x0, **kwargs)
    vals = res.eigenvalues.cpu().numpy()
    vecs = res.eigenvectors.cpu().numpy()
    if freq_limit is not None:
        keep = vals < (2.0 * np.pi * freq_limit) ** 2
        vals, vecs = vals[keep], vecs[:, keep]
    return vals[rigid_modes:], vecs[:, rigid_modes:]


def jacobi_preconditioner(diag: torch.Tensor):
    """Inverse-diagonal preconditioner from diag(A) (n,)."""
    inv = torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))

    def pc(r):
        return r * inv[:, None]

    return pc
