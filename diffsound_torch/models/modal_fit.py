"""Closed-form modal material fit (the `newton` recipe of material_sync).

Counterpart of `diffsound_tpu/models/modal_fit.py`; the free functions are
numpy copies of the JAX package's.  The cached differentiable-eigenvalue
path expresses every corrected eigenvalue as

    lam~_k(mu, lam) = lam0_k + mu q_mu_k + lam q_lam_k - lam0_k q_m_k

which is linear in the Lame parameters at fixed eigenvectors.  Given target
eigenvalues (spectral peaks of the target audio matched to modes), the best
(mu, lam) is a two-parameter weighted linear least squares with a closed
form.  Iterating (eigensolve at the current material) <-> (assign peaks,
solve the LSQ) is a quasi-Newton method on the nonlinear problem: one warm
eigensolve per round.

Aliasing and damping are inverted exactly: a peak at apparent frequency fp
is a damped frequency fd in {fp, sr - fp, sr + fp, ...}, the branch nearest
the prediction is taken per mode, and the undamped eigenvalue follows from
fd^2 = lam / 4pi^2 - (alpha + beta lam)^2 / (4pi)^2 (Rayleigh damping with
the known table alpha, beta), a quadratic in lam.
"""

from __future__ import annotations

import time

import numpy as np


def lambda_from_damped_freq(fd, alpha: float, beta: float):
    """Invert fd = sqrt(lam - d^2) / 2pi with d = (alpha + beta lam) / 2.

    Quadratic in lam: (beta^2/4) lam^2 + (alpha beta / 2 - 1) lam
                      + (alpha^2/4 + (2 pi fd)^2) = 0; the physical root is
    the smaller one (continuous with beta -> 0).  Vectorized, numpy."""
    fd = np.asarray(fd, np.float64)
    w2 = (2.0 * np.pi * fd) ** 2
    if beta == 0.0:
        return w2 + 0.25 * alpha**2
    a = 0.25 * beta * beta
    b = 0.5 * alpha * beta - 1.0
    c = 0.25 * alpha * alpha + w2
    disc = np.maximum(b * b - 4.0 * a * c, 0.0)
    # the physical (smaller) root, stable form for b < 0
    return (2.0 * c) / (-b + np.sqrt(disc))


def unfold_candidates(fp, sr: float, n_images: int = 2):
    """Damped-frequency candidates whose sampled apparent frequency is fp:
    fp, sr - fp, sr + fp, 2 sr - fp, ... (first n_images reflections)."""
    cands = [fp]
    for i in range(1, n_images + 1):
        cands.append(i * sr - fp)
        cands.append(i * sr + fp)
    return np.asarray(cands)


def modal_lsq_fit(
    lam0: np.ndarray,
    q_mu: np.ndarray,
    q_lam: np.ndarray,
    q_m: np.ndarray,
    lam_tgt: np.ndarray,
    weights: np.ndarray,
    nu_bounds=(0.01, 0.499),
):
    """Weighted LSQ for (mu, lam) from lam~(mu, lam) = lam_tgt.

    Residuals are relative (divided by lam_tgt) so high modes don't
    dominate by magnitude.  Returns (mu, lam) with the Poisson ratio
    clamped into nu_bounds (refit of mu along the clamped ray)."""
    const = lam0 * (1.0 - q_m)
    A = np.stack([q_mu, q_lam], axis=1)  # (k, 2)
    b = lam_tgt - const
    sw = np.sqrt(np.maximum(weights, 0.0)) / np.maximum(lam_tgt, 1e-30)
    Aw = A * sw[:, None]
    bw = b * sw
    sol, *_ = np.linalg.lstsq(Aw, bw, rcond=None)
    mu, lam = float(sol[0]), float(sol[1])
    mu = max(mu, 1e-12)
    # nu = lam / (2 (lam + mu)); clamp by refitting along fixed ratio
    nu = lam / (2.0 * (lam + mu)) if lam + mu > 0 else 0.0
    lo, hi = nu_bounds
    if not (lo <= nu <= hi):
        nu_c = min(max(nu, lo), hi)
        r = 2.0 * nu_c / (1.0 - 2.0 * nu_c)  # lam = r mu
        a1 = q_mu + r * q_lam
        denom = float(np.sum((a1 * sw) ** 2))
        mu = max(float(np.sum(a1 * sw * bw)) / max(denom, 1e-30), 1e-12)
        lam = r * mu
    return mu, lam


def lame_to_E_nu(mu: float, lam: float):
    nu = lam / (2.0 * (lam + mu))
    E = mu * (3.0 * lam + 2.0 * mu) / (lam + mu)
    return E, nu


def assign_targets(pred_fd, peaks, pw, sr, match_sigma, lam_from_fd):
    """Per mode: nearest peak in folded log-frequency, unfolded to the
    damped-frequency branch nearest the prediction; weight = peak weight
    x Gaussian(log distance).  lam_from_fd: damped freq -> undamped
    eigenvalue (damping-model specific)."""
    k = len(pred_fd)
    lam_tgt = np.zeros(k)
    w = np.zeros(k)
    for i, fd in enumerate(pred_fd):
        fold_fd = abs(fd - sr * round(fd / sr))
        d = np.abs(np.log(np.maximum(fold_fd, 20.0))
                   - np.log(np.maximum(peaks, 20.0)))
        j = int(np.argmin(d))
        cands = unfold_candidates(peaks[j], sr)
        cands = cands[cands > 0]
        fd_t = float(cands[np.argmin(np.abs(cands - fd))])
        lam_tgt[i] = lam_from_fd(fd_t)
        w[i] = pw[j] * np.exp(-0.5 * (d[j] / match_sigma) ** 2)
    return lam_tgt, w


def _scale_scan(fd, peaks, pw, sr, match_sigma, log_range=2.5, n=501):
    """Score the peak/mode alignment over a grid of global eigenvalue
    scales c (frequency scale sqrt(c)).  Returns (cs, scores).

    log_range 2.5 covers c in [0.082, 12.2]: the flagship's random material
    draw spans E in [1e10, 1e11], so init/target eigenvalue ratios reach
    about 10 in either direction."""
    lp = np.log(np.maximum(peaks, 20.0))
    cs = np.exp(np.linspace(-log_range, log_range, n))
    scores = np.empty(n)
    for i, c in enumerate(cs):
        f = fd * np.sqrt(c)
        fold = np.abs(f - sr * np.round(f / sr))
        lf = np.log(np.maximum(fold, 20.0))
        dmin = np.min(np.abs(lp[:, None] - lf[None, :]), axis=1)
        scores[i] = float(np.sum(pw * np.exp(-0.5 * (dmin / match_sigma) ** 2)))
    return cs, scores


def scale_align(fd, peaks, pw, sr, match_sigma):
    """Best global frequency scale sqrt(c) (uniform Lame scaling is exact:
    see ModalNewtonFitter._scale_align)."""
    cs, scores = _scale_scan(fd, peaks, pw, sr, match_sigma)
    return float(cs[int(np.argmax(scores))])


def scale_align_candidates(fd, peaks, pw, sr, match_sigma,
                           n_cands: int = 3, min_sep: float = 0.2,
                           rel_floor: float = 0.4):
    """Top distinct local maxima of the scale-alignment score, best first.
    Aliasing folds the spectrum, so several scales can align plausibly; the
    fitter runs the fixed-point iteration from each and keeps the fit with
    the highest converged match weight.  min_sep: minimum |log c|
    separation between candidates; rel_floor: discard candidates scoring
    below this fraction of the best."""
    cs, scores = _scale_scan(fd, peaks, pw, sr, match_sigma)
    order = np.argsort(-scores)
    picked = []
    for i in order:
        lc = np.log(cs[i])
        if all(abs(lc - np.log(cs[j])) > min_sep for j in picked):
            picked.append(int(i))
        if len(picked) >= n_cands:
            break
    best = scores[picked[0]]
    return [float(cs[i]) for i in picked if scores[i] >= rel_floor * best]


def _host(x) -> np.ndarray:
    """A device tensor as float64 numpy."""
    return x.detach().double().cpu().numpy()


class ModalNewtonFitter:
    """Iterated assign + closed-form LSQ material fit.

    model: the port's DiffSoundObject (material task); peaks/weights from
    audio.freq_loss.extract_spectral_peaks on the target audio; alpha,
    beta: the synthesis model's (known) Rayleigh damping table values.
    Works in density-normalized Lame space (model.material_lame
    convention).

    Every eigensolve the fitter runs is recorded in `solves`: one dict per
    solve with `warm` (LOBPCG from the previous eigenvectors, else the cold
    host ARPACK), its LOBPCG `iterations` and its wall `seconds` (with a
    device sync)."""

    def __init__(self, model, peaks, peak_weights, sr, alpha, beta,
                 match_sigma: float = 0.06, damping_curve=None):
        if len(np.atleast_1d(peaks)) == 0:
            raise ValueError(
                "no spectral peaks extracted from the target audio "
                "(silent/degenerate input?): the modal fit has nothing "
                "to match; use the gradient recipe instead"
            )
        self.model = model
        self.peaks = np.asarray(peaks, np.float64)
        self.pw = np.asarray(peak_weights, np.float64)
        self.sr = float(sr)
        self.alpha = float(alpha)
        self.beta = float(beta)
        # Gaussian gate width in log-frequency for assignment confidence
        self.match_sigma = match_sigma
        # real-audio path: damping d(f_undamped) extracted from recordings
        # (audio/damping.DampingCurve) instead of the Rayleigh table; then
        # lam = (2 pi fd)^2 + d^2 directly (d does not depend on lam)
        self.damping_curve = damping_curve
        self.solves = []

    def _lam_from_fd(self, fd):
        if self.damping_curve is None:
            return lambda_from_damped_freq(fd, self.alpha, self.beta)
        d = float(np.asarray(self.damping_curve(np.asarray([fd]))).reshape(-1)[0])
        return (2.0 * np.pi * fd) ** 2 + d * d

    def _fd_from_lam(self, lam_el):
        if self.damping_curve is None:
            d = 0.5 * (self.alpha + self.beta * lam_el)
        else:
            f_und = np.sqrt(np.maximum(lam_el, 0.0)) / (2 * np.pi)
            d = np.asarray(self.damping_curve(f_und)).reshape(lam_el.shape)
        return np.sqrt(np.maximum(lam_el - d * d, 1e-12)) / (2 * np.pi)

    def _assign_targets(self, pred_fd):
        return assign_targets(
            pred_fd, self.peaks, self.pw, self.sr, self.match_sigma,
            self._lam_from_fd,
        )

    def _scale_align(self, fd):
        """Global 1-D pre-alignment: scaling (mu, lam) by c scales every
        eigenvalue by c and every frequency by sqrt(c) exactly (K linear in
        the Lame pair, eigenvectors unchanged), so the best overall
        frequency scale is a cheap host scan."""
        return scale_align(fd, self.peaks, self.pw, self.sr, self.match_sigma)

    def _solve(self, mu: float, lam: float, eig):
        """One eigensolve at (mu, lam), warm from `eig` when given, and the
        modal cache pulled to the host as float64 numpy."""
        t0 = time.perf_counter()
        new = self.model.eigen_decomposition_at_lame(mu, lam, prev=eig)
        cache = self.model.modal_cache(new)
        host = [_host(x) for x in (cache.eigenvalues, cache.q_mu, cache.q_lam, cache.q_m)]
        self.solves.append({"warm": eig is not None, "iterations": int(new.iterations),
                            "seconds": time.perf_counter() - t0})
        return new, host

    def fit(self, mu0: float, lam0_lame: float, rounds: int = 6,
            eig=None, verbose: bool = False, n_scale_candidates: int = 3):
        """Run the fixed-point iteration from Lame (mu0, lam0_lame)
        (density-normalized).  Returns a dict with E, nu, mu, lam, history,
        and the final EigenState (warm-startable downstream).

        The global scale pre-alignment is multi-start: aliasing makes
        several frequency scales align plausibly, and a wrong lock-in
        converges to a self-consistent wrong answer.  Each candidate scale
        (scale_align_candidates) runs the full fixed-point iteration from
        the shared initial eigenbasis, and the converged fit with the
        highest total match weight wins."""
        model = self.model
        mu, lam = float(mu0), float(lam0_lame)
        # initial eigensolve at the unscaled init, shared by every scale
        # candidate (uniform Lame scaling leaves eigenvectors unchanged)
        eig, (lam0, q_mu, q_lam, q_m) = self._solve(mu, lam, eig)
        nr = model.extra_modes
        lam_now = lam0 + mu * q_mu + lam * q_lam - lam0 * q_m
        fd = self._fd_from_lam(lam_now[nr:])
        cands = scale_align_candidates(
            fd, self.peaks, self.pw, self.sr, self.match_sigma,
            n_cands=n_scale_candidates,
        )
        if verbose and (len(cands) > 1 or abs(cands[0] - 1.0) > 1e-3):
            print(f"  scale pre-alignment candidates: "
                  f"{[f'{c:.3f}' for c in cands]}")
        best = None
        for c in cands:
            res = self._fit_iterate(mu * c, lam * c, rounds, eig, verbose)
            if best is None or res["final_match_w"] > best["final_match_w"]:
                best = res
            if verbose and len(cands) > 1:
                print(f"  candidate c={c:.3f}: E {res['E']:.4g} nu "
                      f"{res['nu']:.4f} match_w {res['final_match_w']:.3f}")
        return best

    def _fit_iterate(self, mu: float, lam: float, rounds: int, eig,
                     verbose: bool = False):
        """The assign/LSQ fixed-point iteration from a concrete start."""
        model = self.model
        nr = model.extra_modes
        hist = []
        for r in range(rounds):
            eig, (lam0, q_mu, q_lam, q_m) = self._solve(mu, lam, eig)
            lam_now = lam0 + mu * q_mu + lam * q_lam - lam0 * q_m
            fd = self._fd_from_lam(lam_now[nr:])
            lam_tgt, w = self._assign_targets(fd)
            mu_n, lam_n = modal_lsq_fit(
                lam0[nr:], q_mu[nr:], q_lam[nr:], q_m[nr:], lam_tgt, w
            )
            E, nu = lame_to_E_nu(mu_n, lam_n)
            hist.append({"round": r, "mu": mu_n, "lam": lam_n,
                         "E": E * model.mat.density, "nu": nu,
                         "match_w": float(w.sum())})
            if verbose:
                print(f"  modal fit round {r}: E {E * model.mat.density:.4g} "
                      f"nu {nu:.4f} (match weight {w.sum():.3f})")
            converged = (
                abs(mu_n - mu) < 1e-4 * abs(mu) and abs(lam_n - lam) < 1e-4 * max(abs(lam), 1e-12)
            )
            mu, lam = mu_n, lam_n
            if converged:
                break
        # the f32 warm-solve noise makes (mu, lam) jitter ~1e-3 round to
        # round at the fixed point; the median of the settled tail is a
        # better estimate than the last sample
        tail = hist[-min(5, max(1, len(hist) - 2)):]
        mu = float(np.median([h["mu"] for h in tail]))
        lam = float(np.median([h["lam"] for h in tail]))
        E, nu = lame_to_E_nu(mu, lam)
        return {
            "mu": mu, "lam": lam,
            "E": E * model.mat.density, "nu": nu,
            "history": hist, "eig": eig,
            "final_match_w": float(np.median([h["match_w"] for h in tail])),
        }
