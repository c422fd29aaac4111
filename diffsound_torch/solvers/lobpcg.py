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

`lobpcg_batched` solves B independent pencils at once on (B, n, m) blocks:
the counterpart of `jax.vmap(lobpcg)` in the JAX package's parallel
trainer, with vmap's semantics (each member iterates until its own exit
test passes, then its state freezes).

While `utils.profiler.tracing()` is open, each iteration of either solver
is a `diffsound.lobpcg.sweep` span and counts `lobpcg.sweeps`,
`lobpcg.pair_sweeps` (the batch's members) and `lobpcg.pair_sweeps_active`
(the members still iterating, read with the exit test's one host sync);
the batched solver also spans its exit test (`diffsound.lobpcg.exit`),
orthonormalisation (`diffsound.lobpcg.orth`) and `eigh`
(`diffsound.lobpcg.eigh`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..utils.profiler import count, device_trace, span, tracing

# converged guard columns sit within about 2x of the wanted block's largest
# Ritz value; the residual scale counts guards up to this multiple of it
GUARD_SCALE_CAP = 4.0


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
    profiler: Optional[str] = None,
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
    profiler: a trace directory: the solve runs under
        `utils.profiler.device_trace(profiler)` with `tracing()` open, so
        each iteration is a `diffsound.lobpcg.sweep` span, and prints a host
        line per iteration (max relative residual, milliseconds after a
        device sync).
    """
    with torch.no_grad():
        return _lobpcg(
            a_fn, b_fn, x0, precond_fn, max_iters, tol, gram_dtype, seed,
            reuse_products, record_history, row_mask, num_wanted, profiler,
        )


class _Spans:
    """Each iteration's `diffsound.lobpcg.sweep` span, and the profiler
    option: with a trace directory, the solve traced with `tracing()` open
    and a host line per iteration after a device sync."""

    def __init__(self, profiler: Optional[str], device):
        self.profiler, self.device = profiler, device

    @contextlib.contextmanager
    def trace(self):
        if self.profiler is None:
            yield
            return
        with device_trace(self.profiler), tracing():
            yield

    @contextlib.contextmanager
    def iteration(self, it: int, rel_fn):
        t0 = time.perf_counter()
        with span("diffsound.lobpcg.sweep"):
            yield
            if self.profiler is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self.profiler is not None:
            print(f"  lobpcg iter {it + 1}: max rel resid {float(rel_fn().max()):.3e} "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms)", flush=True)


def _lobpcg(a_fn, b_fn, x0, precond_fn, max_iters, tol, gram_dtype, seed,
            reuse_products, record_history, row_mask, num_wanted, profiler=None):
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
    spans = _Spans(profiler, device)
    with spans.trace():
        while it < max_iters and float(rel[:nw].max()) > tol:
            count("lobpcg.sweeps")
            count("lobpcg.pair_sweeps")
            count("lobpcg.pair_sweeps_active")
            with spans.iteration(it, lambda: rel[:nw]):
                if not reuse_products:
                    AX = a_fn(X)
                    BX = b_fn(X)
                R = AX - BX * theta[None, :]

                # Relative residuals, computed before the step and reported at exit.
                # The scale includes the block's largest Ritz value so near-null
                # (rigid-body) modes, where ||A x|| itself is roundoff, still count
                # as converged; capped at GUARD_SCALE_CAP times the wanted block's
                # largest: a noise-seeded guard's Ritz value can sit 1e7 x above the
                # block (a marching-tets mesh's slivers) and would pass every wanted
                # column at the first check.
                rn = torch.linalg.vector_norm(R, dim=0)
                top = torch.minimum(theta.abs().max(), GUARD_SCALE_CAP * theta[:nw].abs().max())
                scale = (theta.abs() + top) * torch.linalg.vector_norm(
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


def _chol_inv_t_batched(G: torch.Tensor):
    """inv(chol(G)).mT of a batch of small SPD matrices, and cholesky_ex's
    info (nonzero where a member is not positive definite)."""
    L, info = torch.linalg.cholesky_ex(G)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device).expand_as(G)
    return torch.linalg.solve_triangular(L, eye, upper=False).mT, info


def _b_orthonormalize_batched(S, BS, gram_dtype):
    """`_b_orthonormalize` on (B, n, c) blocks; also returns whether any
    member's Cholesky failed."""

    def one_pass(S, BS):
        G = S.to(gram_dtype).mT @ BS.to(gram_dtype)
        d = torch.rsqrt(torch.clamp(torch.diagonal(G, dim1=1, dim2=2),
                                    min=torch.finfo(gram_dtype).tiny))
        G = G * d[:, :, None] * d[:, None, :]
        c = G.shape[-1]
        jitter = 10.0 * c * torch.finfo(S.dtype).eps
        Linv_t, info = _chol_inv_t_batched(
            G + jitter * torch.eye(c, dtype=gram_dtype, device=G.device))
        Linv_t, dc = Linv_t.to(S.dtype), d.to(S.dtype)[:, None, :]
        return (S * dc) @ Linv_t, (BS * dc) @ Linv_t, info != 0

    with span("diffsound.lobpcg.orth"):
        bad = torch.zeros(S.shape[0], dtype=torch.bool, device=S.device)
        S, BS, bad1 = one_pass(S, BS)
        S, BS, bad2 = one_pass(S, BS)
        return S, BS, bad | bad1 | bad2


def lobpcg_batched(
    a_fn: Callable[[torch.Tensor], torch.Tensor],
    b_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iters: int = 200,
    tol: float = 1e-6,
    profiler: Optional[str] = None,
) -> LobpcgResult:
    """B independent generalized eigensolves on one (B, n, m) block.

    a_fn/b_fn map (B, n, k) -> (B, n, k), member b through its own pencil.
    The body is `lobpcg`'s recompute body without preconditioning; member b
    runs until its own exit test passes (or max_iters), then its state
    freezes while the others iterate, so member b's result is `lobpcg` on
    pencil b alone at its defaults (seed 0, float64 Grams).  The random P is drawn once, as
    `lobpcg` draws it, and shared by every member.  One host sync per
    iteration (the exit test of all members at once).

    Returns a LobpcgResult with eigenvalues (B, m), eigenvectors (B, n, m),
    residual_norms (B, m) and iterations, a list of B ints.
    """
    with torch.no_grad():
        return _lobpcg_batched(a_fn, b_fn, x0, max_iters, tol, profiler)


def _lobpcg_batched(a_fn, b_fn, x0, max_iters, tol, profiler):
    B, n, m = x0.shape
    dtype, device = x0.dtype, x0.device
    gram_dtype = torch.float64
    tiny = torch.finfo(dtype).tiny
    gen = torch.Generator(device=device).manual_seed(0)
    P = torch.randn((n, m), generator=gen, dtype=dtype, device=device).expand(B, n, m)

    def ritz(S, AS, active):
        G = S.to(gram_dtype).mT @ AS.to(gram_dtype)
        G = 0.5 * (G + G.mT)
        # frozen members may hold a degenerate Gram; eigh sees the identity
        eye = torch.eye(G.shape[-1], dtype=gram_dtype, device=device)
        G = torch.where(active[:, None, None], G, eye)
        with span("diffsound.lobpcg.eigh"):
            return torch.linalg.eigh(G)

    every = torch.ones(B, dtype=torch.bool, device=device)
    X, BX, failed = _b_orthonormalize_batched(x0, b_fn(x0), gram_dtype)
    AX = a_fn(X)
    th0, Z0 = ritz(X, AX, every)
    X = X @ Z0.to(dtype)
    theta = th0.to(dtype)

    rel = torch.full((B, m), float("inf"), dtype=dtype, device=device)
    its = torch.zeros(B, dtype=torch.int64, device=device)
    spans = _Spans(profiler, device)
    sweep = 0
    with spans.trace():
        while True:
            with span("diffsound.lobpcg.exit"):
                active = (its < max_iters) & (rel.amax(dim=1) > tol)
                n_active, n_failed = torch.stack([active.sum(), failed.sum()]).tolist()
            if n_failed:
                # where `lobpcg`'s Cholesky raises
                raise torch.linalg.LinAlgError(
                    "lobpcg_batched: a member's B-Gram is not positive definite")
            if not n_active:
                break
            count("lobpcg.sweeps")
            count("lobpcg.pair_sweeps", B)
            count("lobpcg.pair_sweeps_active", n_active)
            with spans.iteration(sweep, lambda: rel):
                AX, BX = a_fn(X), b_fn(X)
                R = AX - BX * theta[:, None, :]
                rn = torch.linalg.vector_norm(R, dim=1)
                top = theta.abs().amax(dim=1, keepdim=True)
                scale = (theta.abs() + top) * torch.linalg.vector_norm(BX, dim=1) + \
                    torch.linalg.vector_norm(AX, dim=1)
                rel_new = rn / torch.clamp(scale, min=tiny)

                S = torch.cat([X, R, P], dim=2)
                S, BS, bad_new = _b_orthonormalize_batched(S, b_fn(S), gram_dtype)
                AS = a_fn(S)
                ritz_vals, Z = ritz(S, AS, active)
                Zm = Z[:, :, :m].to(dtype)
                # "ortho" conjugate-direction update: drop the X-block component
                Zp = Zm.clone()
                Zp[:, :m, :] = 0.0
                keep = active[:, None, None]
                X = torch.where(keep, S @ Zm, X)
                P = torch.where(keep, S @ Zp, P)
                theta = torch.where(active[:, None], ritz_vals[:, :m].to(dtype), theta)
                rel = torch.where(active[:, None], rel_new, rel)
                failed = failed | (active & bad_new)
                its = its + active.to(its.dtype)
            sweep += 1

    return LobpcgResult(
        eigenvalues=theta, eigenvectors=X, iterations=its.tolist(), residual_norms=rel,
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
