"""Damping curve extracted from a fitted ground-truth oscillator.

Counterpart of `diffsound_tpu/audio/damping.py` (numpy): keep modes with
damping < 300, take the per-500 Hz-band minimum of the fitted dampings over
[20, 20000] Hz, and interpolate linearly (with extrapolation) to evaluate
the curve at any frequency."""

from __future__ import annotations

import numpy as np


class DampingCurve:
    def __init__(self, freqs: np.ndarray, damps: np.ndarray,
                 damp_limit: float = 300.0, band_hz: float = 500.0):
        freqs = np.asarray(freqs).reshape(-1)
        damps = np.asarray(damps).reshape(-1)
        keep = damps < damp_limit
        freqs, damps = freqs[keep], damps[keep]
        xs, ys = [], []
        for lo in np.arange(20.0, 20000.0, band_hz):
            m = (freqs > lo) & (freqs < lo + band_hz)
            if not m.any():
                continue
            xs.append(lo + band_hz / 2)
            ys.append(damps[m].min())
        if len(xs) < 2:
            raise ValueError("not enough damping samples to build a curve")
        self.x = np.asarray(xs)
        self.y = np.asarray(ys)

    def __call__(self, f):
        """Linear interpolation with linear extrapolation, clamped to a small
        positive floor: a negative extrapolated damping is unphysical and
        makes the envelope exp(+|d| t) overflow f32."""
        f = np.asarray(f, np.float64)
        i = np.clip(np.searchsorted(self.x, f) - 1, 0, len(self.x) - 2)
        x0, x1 = self.x[i], self.x[i + 1]
        y0, y1 = self.y[i], self.y[i + 1]
        return np.clip(y0 + (f - x0) * (y1 - y0) / (x1 - x0), 1e-3, None)
