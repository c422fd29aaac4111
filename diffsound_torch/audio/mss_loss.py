"""Multi-scale spectral losses (L1 / RMSE).

Counterpart of `diffsound_tpu/audio/mss_loss.py`:

  * 'l1_loss':   time-weighted L1 on log + linear spectrograms, DC removed
  * 'rmse_loss': sqrt(MSE) on eps-anchored log spectrograms
  * 'geomloss':  not ported yet (ROADMAP.md, Queue 1: the Sinkhorn early
                 phase, `audio/sinkhorn.py`); raises NotImplementedError.

`target_cache` precomputes the target-side spectrograms once per training
run; passing it to `__call__` gives bit-identical losses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from .stft import spectrogram

_GEOMLOSS_TODO = (
    "loss_type='geomloss' needs the Sinkhorn divergence (audio/sinkhorn.py), "
    "not ported yet: ROADMAP.md Queue 1, 'sinkhorn'"
)


def weighted_l1(x_pred, x_true):
    """Time-weighted L1 with the DC bin removed."""
    T = x_pred.shape[-1]
    w = 1.0 - torch.linspace(1.0, 0.9, T, dtype=x_pred.dtype, device=x_pred.device)
    w = w / w.sum() * T
    w = w[None, None, :]
    return (x_pred[:, 1:, :] * w - x_true[:, 1:, :] * w).abs().mean()


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
        return torch.log2(x + self.eps) - math.log2(self.eps)

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
            raise NotImplementedError(_GEOMLOSS_TODO)
        raise ValueError(f"unknown loss type {self.loss_type}")

    def __call__(self, x_pred, x_true, freqs=None, scale=1.0, target_cache=None):
        if self.loss_type == "l1_loss":
            lin_t, log_t = (
                target_cache if target_cache is not None
                else self.target_cache(x_true, scale)
            )
            lin_p = spectrogram(x_pred, self.n_fft, self.hop)
            log_p = torch.log2(lin_p + self.eps)
            return self.alpha * weighted_l1(log_p, log_t) + weighted_l1(lin_p, lin_t)

        if self.loss_type == "rmse_loss":
            (lt,) = (
                target_cache if target_cache is not None
                else self.target_cache(x_true, scale)
            )
            lp = self.log_spec(x_pred, scale)
            return torch.sqrt(((lp - lt) ** 2).mean())

        if self.loss_type == "geomloss":
            raise NotImplementedError(_GEOMLOSS_TODO)
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

    def __post_init__(self):
        if self.loss_type == "geomloss":
            raise NotImplementedError(_GEOMLOSS_TODO)

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

    def __call__(self, x_pred, x_true, freqs=None, scale=1.0, target_cache=None):
        total = 0.0
        for i, sss in enumerate(self._scales()):
            tc = target_cache[i] if target_cache is not None else None
            total = total + sss(x_pred, x_true, freqs, scale, target_cache=tc)
        return total
