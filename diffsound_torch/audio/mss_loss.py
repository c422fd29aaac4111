"""Multi-scale spectral losses (L1 / RMSE / Sinkhorn-OT).

Counterpart of `diffsound_tpu/audio/mss_loss.py`:

  * 'l1_loss':   time-weighted L1 on log + linear spectrograms, DC removed
  * 'rmse_loss': sqrt(MSE) on eps-anchored log spectrograms
  * 'geomloss':  debiased Sinkhorn over spectrogram columns as point clouds,
                 with the predicted damped mode frequencies injected into
                 the points' positions (`spec_to_points`): the gradient
                 that reaches across large frequency mismatches in the
                 early phase of material inference.

`target_cache` precomputes the target-side spectrograms once per training
run; passing it to `__call__` gives bit-identical losses.  The small
utility losses at the end (`lsd_loss`, `mode_loss`, `mel_scale`,
`inv_mel_scale`, `reconstruct_signal`) are the JAX package's, for
evaluation scripts; no trainer calls them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .sinkhorn import sinkhorn_divergence
from .stft import spectrogram


def _interp_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch F.interpolate(mode='linear', align_corners=False) on the last
    axis: x (..., T) -> (..., size)."""
    T = x.shape[-1]
    scale = T / size
    pos = (np.arange(size) + 0.5) * scale - 0.5
    pos = np.clip(pos, 0.0, T - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = torch.as_tensor(pos - lo, dtype=x.dtype, device=x.device)
    lo, hi = (torch.as_tensor(i, device=x.device) for i in (lo, hi))
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def weighted_l1(x_pred, x_true, per_row: bool = False):
    """Time-weighted L1 with the DC bin removed; per_row: one mean per
    leading row (B,) instead of one over all."""
    T = x_pred.shape[-1]
    w = 1.0 - torch.linspace(1.0, 0.9, T, dtype=x_pred.dtype, device=x_pred.device)
    w = w / w.sum() * T
    w = w[None, None, :]
    err = (x_pred[:, 1:, :] * w - x_true[:, 1:, :] * w).abs()
    return err.mean(dim=(1, 2)) if per_row else err.mean()


def _last_writes(bins: torch.Tensor, vals: torch.Tensor, ok: torch.Tensor, F: int):
    """What `zeros(F).at[bins].set(where(ok, vals, 0))` and
    `zeros(F, bool).at[bins].set(ok)` leave, deterministically: where several
    modes write one bin, the last in mode order wins, for the value and the
    mask alike (the JAX package's rule on the CPU).  Returns (upd (F,),
    mask (F,)); the gradient reaches only the winning mode's value."""
    M = bins.shape[0]
    hit = bins[None, :] == torch.arange(F, device=bins.device)[:, None]  # (F, M)
    order = torch.arange(1, M + 1, device=bins.device)
    last = (hit * order).amax(dim=1) - 1  # (F,), -1 where no mode writes
    li = last.clamp(min=0)
    mask = (last >= 0) & ok[li]
    return torch.where(mask, vals[li], torch.zeros_like(vals[li])), mask


def spec_to_points(
    spec: torch.Tensor,
    freqs: Optional[torch.Tensor] = None,
    sample_rate: Optional[float] = None,
) -> torch.Tensor:
    """(B, F, T) spectrogram -> (B, F, 4) point cloud: 3 time-pooled
    features and the normalized frequency position.  Predicted mode
    frequencies (M,) move the positions of their +-2 neighbouring bins so
    optimal transport can move spectral mass toward or away from them.
    Features are detached: the gradient path is through the positions."""
    B, F, T = spec.shape
    feats = _interp_linear(spec.detach(), 3)  # (B, F, 3)
    pos = (torch.arange(F, dtype=spec.dtype, device=spec.device) / F)[None, :].expand(B, F)

    if freqs is not None:
        f = freqs.reshape(-1).to(spec.dtype)  # (M,)
        centers = F / (sample_rate // 2) * f  # fractional bin of each mode
        # width-2 neighbourhood, outer offsets written first so the center
        # (w=0) wins on collision
        for wdt in (2, 1, 0):
            for sgn in (-1.0, 1.0) if wdt > 0 else (1.0,):
                tgt = centers + sgn * wdt
                bins = torch.floor(tgt.detach()).to(torch.int64)
                ok = (bins >= 0) & (bins < F)
                upd, mask = _last_writes(bins.clamp(0, F - 1), tgt / F, ok, F)
                pos = torch.where(mask[None, :], upd[None, :], pos)

    return torch.cat([feats, pos[..., None]], dim=-1)  # (B, F, 4)


def _peak_normalize(x):
    """x over its detached max |x| along the last axis."""
    return x / (x.detach().abs().amax(dim=-1, keepdim=True) + 1e-7)


@dataclass(frozen=True)
class SSSLoss:
    """Single-scale spectral loss."""

    n_fft: int
    sample_rate: float
    alpha: float = 1.0
    overlap: float = 0.75
    eps: float = 1e-7
    loss_type: str = "l1_loss"

    @property
    def hop(self):
        return int(self.n_fft * (1 - self.overlap))

    def log_func(self, x):
        """log2(x + eps) - log2(eps), returned in float64 as the JAX
        package's: it subtracts a numpy float64 constant, which (x64 on)
        promotes its log spectra, and so its geomloss log-feature Sinkhorn
        and its rmse, to float64."""
        return torch.log2(x + self.eps).to(torch.float64) - math.log2(self.eps)

    def log_spec(self, x, scale=1.0):
        S = spectrogram(x, self.n_fft, self.hop)
        S = S[..., : int(S.shape[-2] * scale), :]
        return self.log_func(S)

    def target_cache(self, x_true, scale=1.0):
        """Every target-side tensor __call__ needs, computed once."""
        if self.loss_type == "l1_loss":
            lin_t = spectrogram(x_true, self.n_fft, self.hop)
            return (lin_t, torch.log2(lin_t + self.eps))
        if self.loss_type == "rmse_loss":
            return (self.log_spec(x_true, scale),)
        if self.loss_type == "geomloss":
            x_t = _peak_normalize(x_true)
            return (
                spec_to_points(self.log_spec(x_t, scale) / 40.0),
                spec_to_points(spectrogram(x_t, self.n_fft, self.hop)),
            )
        raise ValueError(f"unknown loss type {self.loss_type}")

    def __call__(self, x_pred, x_true, freqs=None, scale=1.0, target_cache=None,
                 per_row: bool = False):
        if per_row and self.loss_type != "l1_loss":
            raise ValueError(f"per_row is an option of l1_loss, not {self.loss_type}")
        if self.loss_type == "l1_loss":
            lin_t, log_t = (
                target_cache if target_cache is not None
                else self.target_cache(x_true, scale)
            )
            lin_p = spectrogram(x_pred, self.n_fft, self.hop)
            log_p = torch.log2(lin_p + self.eps)
            return (self.alpha * weighted_l1(log_p, log_t, per_row)
                    + weighted_l1(lin_p, lin_t, per_row))

        if self.loss_type == "rmse_loss":
            (lt,) = (
                target_cache if target_cache is not None
                else self.target_cache(x_true, scale)
            )
            lp = self.log_spec(x_pred, scale)
            return torch.sqrt(((lp - lt) ** 2).mean())

        if self.loss_type == "geomloss":
            pts_log_t, pts_lin_t = (
                target_cache if target_cache is not None
                else self.target_cache(x_true, scale)
            )
            x_p = _peak_normalize(x_pred)
            lin_p = spectrogram(x_p, self.n_fft, self.hop)
            log_p = self.log_spec(x_p, scale) / 40.0
            loss_log = sinkhorn_divergence(
                spec_to_points(log_p, freqs, self.sample_rate), pts_log_t).sum()
            loss_lin = sinkhorn_divergence(
                spec_to_points(lin_p, freqs, self.sample_rate), pts_lin_t).sum()
            return self.alpha * loss_log + loss_lin
        raise ValueError(f"unknown loss type {self.loss_type}")


@dataclass(frozen=True)
class MSSLoss:
    """Multi-scale spectral loss over a list of FFT sizes."""

    n_ffts: Sequence[int]
    sample_rate: float
    alpha: float = 1.0
    overlap: float = 0.75
    eps: float = 1e-7
    loss_type: str = "l1_loss"

    def _scales(self):
        return [
            SSSLoss(
                n_fft, self.sample_rate, self.alpha, self.overlap, self.eps,
                self.loss_type,
            )
            for n_fft in self.n_ffts
        ]

    def target_cache(self, x_true, scale=1.0):
        """Per-scale target-side tensors (see SSSLoss.target_cache)."""
        return tuple(s.target_cache(x_true, scale) for s in self._scales())

    def __call__(self, x_pred, x_true, freqs=None, scale=1.0, target_cache=None,
                 per_row: bool = False):
        """The sum over scales; per_row (l1_loss only): (A,) losses of the
        rows of (A, T) signals, each the loss of that row alone."""
        total = 0.0
        for i, sss in enumerate(self._scales()):
            tc = target_cache[i] if target_cache is not None else None
            total = total + sss(x_pred, x_true, freqs, scale, target_cache=tc,
                                per_row=per_row)
        return total


# ---------------------------------------------------------------------------
# Small spectral utility losses
# ---------------------------------------------------------------------------


def lsd_loss(spec_pred, spec_true, eps: float = 1e-7):
    """Log-spectral distance."""
    lp = torch.log10(spec_pred.abs() + eps)
    lt = torch.log10(spec_true.abs() + eps)
    return torch.sqrt(((lp - lt) ** 2).mean())


def mode_loss(pred_freqs, gt_freqs):
    """Nearest-mode relative error plus the fundamental's relative error."""
    R = (pred_freqs[:, None] - gt_freqs[None, :]) ** 2
    err = torch.sqrt(R.amin(dim=0)) / gt_freqs
    return err.mean() + (pred_freqs[0] - gt_freqs[0]).abs() / gt_freqs[0]


def mel_scale(freq):
    """Hz -> mel."""
    return 2595.0 * torch.log10(1.0 + freq / 700.0)


def inv_mel_scale(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def reconstruct_signal(undamped_freq, damp, sample_num: int, sample_rate: float):
    """Sum of undamped sinusoids at the damped frequencies."""
    damped = torch.sqrt(
        torch.clamp((2 * math.pi * undamped_freq) ** 2 - damp**2, min=0.0)
    ) / (2 * math.pi)
    t = torch.arange(sample_num, dtype=damped.dtype, device=damped.device) / sample_rate
    return torch.sin(2 * math.pi * damped[:, None] * t[None, :]).sum(dim=0)
