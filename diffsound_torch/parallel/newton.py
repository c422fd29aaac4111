"""Batched modal-Newton material fit: every pair's (E, nu) at once.

Counterpart of `diffsound_tpu/parallel/newton.py`, the multi-pair form of
`models/modal_fit.py`.  Each round is one batched warm refresh at every
pair's current (mu, lambda) on the trainer's sharded operators, with each
pair's quadratic forms (q_mu, q_lam, q_m), followed by a host step per pair:
scale alignment in round 0, the peak assignment and the closed-form
two-parameter least squares.  The fit settles on the median of the last
four rounds (float32 refreshes jitter).

Host arrays (peaks, start materials) cover all B pairs; device tensors
(the start basis) hold this rank's pairs, `mesh.pair_slice(B)`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.modal_fit import (
    assign_targets, lambda_from_damped_freq, lame_to_E_nu, modal_lsq_fit, scale_align,
)


class BatchedModalNewton:
    """trainer: a `parallel.train.MultipairTrainer` (its sharded operators
    and batched solve).  peaks_list/pw_list: every pair's spectral peaks
    and weights (`audio.freq_loss.extract_spectral_peaks`)."""

    def __init__(self, trainer, peaks_list, pw_list, sr, alpha, beta,
                 match_sigma: float = 0.06, refresh_iters: int = 60,
                 refresh_tol: float = 1e-3):
        self.tr = trainer
        sl = trainer.mesh.pair_slice(len(peaks_list))
        self.peaks_list = [np.asarray(p, np.float64) for p in peaks_list[sl]]
        self.pw_list = [np.asarray(w, np.float64) for w in pw_list[sl]]
        self.sr = float(sr)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.match_sigma = match_sigma
        self.refresh_iters = refresh_iters
        self.refresh_tol = refresh_tol

    def _lam_from_fd(self, fd):
        return lambda_from_damped_freq(fd, self.alpha, self.beta)

    def _fd_of(self, lam_el):
        d = 0.5 * (self.alpha + self.beta * lam_el)
        return np.sqrt(np.maximum(lam_el - d * d, 1e-12)) / (2 * np.pi)

    def fit(self, mu0_b, lam0_b, eigvec0_b, rounds: int = 12, verbose: bool = False):
        """mu0_b/lam0_b (B,) density-normalized Lame starts of all pairs;
        eigvec0_b (B_local, n, k) this rank's start bases (one cold solve
        broadcast will do: the first refresh adapts each pair).  Returns a
        dict of all pairs' E, nu, mu, lam (B,), the history (rounds, B, 2)
        of (mu, lam), the LOBPCG iterations per round (rounds, B) and this
        rank's final eigenvectors."""
        mesh = self.tr.mesh
        sl = mesh.pair_slice(len(mu0_b))
        B = sl.stop - sl.start
        # the Lame values are float32, as the JAX package's fit carries them
        mu_b = torch.as_tensor(np.asarray(mu0_b)[sl], dtype=torch.float32, device=mesh.device)
        lam_b = torch.as_tensor(np.asarray(lam0_b)[sl], dtype=torch.float32, device=mesh.device)
        eigvec_b = eigvec0_b
        nr = self.tr.extra_modes
        hist, iters = [], []
        for r in range(rounds):
            eigval_b, eigvec_b, its = self.tr.solve(mu_b, lam_b, eigvec_b, self.refresh_iters,
                                                    self.refresh_tol)
            qmu, qlam, qm = self.tr.quadratic_forms(eigvec_b).double().cpu().numpy()
            lam0 = eigval_b.double().cpu().numpy()
            mu_h = mu_b.double().cpu().numpy()
            lam_h = lam_b.double().cpu().numpy()
            mu_new, lam_new = np.zeros(B), np.zeros(B)
            for b in range(B):
                lam_now = (lam0[b] + mu_h[b] * qmu[b] + lam_h[b] * qlam[b]
                           - lam0[b] * qm[b])[nr:]
                fd = self._fd_of(lam_now)
                if r == 0:
                    c = scale_align(fd, self.peaks_list[b], self.pw_list[b], self.sr,
                                    self.match_sigma)
                    mu_h[b] *= c
                    lam_h[b] *= c
                    fd = self._fd_of(lam_now * c)
                lam_tgt, w = assign_targets(fd, self.peaks_list[b], self.pw_list[b], self.sr,
                                            self.match_sigma, self._lam_from_fd)
                mu_new[b], lam_new[b] = modal_lsq_fit(
                    lam0[b][nr:], qmu[b][nr:], qlam[b][nr:], qm[b][nr:], lam_tgt, w,
                )
            hist.append(np.stack([mu_new, lam_new], axis=1))
            iters.append(its)
            mu_b = torch.as_tensor(mu_new, dtype=torch.float32, device=mesh.device)
            lam_b = torch.as_tensor(lam_new, dtype=torch.float32, device=mesh.device)
            if verbose:
                E = [lame_to_E_nu(m, l)[0] for m, l in zip(mu_new, lam_new)]
                print(f"  batched fit round {r}: E[:4] {[f'{e:.3g}' for e in E[:4]]}, "
                      f"LOBPCG iterations {its}")
        # every round's (mu, lam) and iterations of all pairs, in pair order
        hist = mesh.gather_pairs(torch.as_tensor(np.stack(hist, 1), device=mesh.device))
        iters = mesh.gather_pairs(torch.as_tensor(iters, device=mesh.device).T)
        hist = hist.cpu().numpy().transpose(1, 0, 2)  # (rounds, B, 2)
        # settle on the median of the tail (float32 refresh jitter)
        tail = hist[-min(4, len(hist)):]
        mu_f = np.median(tail[..., 0], axis=0)
        lam_f = np.median(tail[..., 1], axis=0)
        E, nu = np.zeros(len(mu_f)), np.zeros(len(mu_f))
        for b in range(len(mu_f)):
            e, n = lame_to_E_nu(float(mu_f[b]), float(lam_f[b]))
            E[b] = e * self.tr.bins.mat.density
            nu[b] = n
        return {"E": E, "nu": nu, "mu": mu_f, "lam": lam_f, "history": list(hist),
                "iterations": iters.cpu().numpy().T, "eigvec": eigvec_b}
