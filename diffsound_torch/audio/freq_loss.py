"""Spectral-peak frequency matching: the ripple-free early phase and late
auxiliary of material inference, and the peak sets the modal-Newton fit
matches.

Counterpart of `diffsound_tpu/audio/freq_loss.py`.  Modal peaks are
extracted once from the target audio on the host (numpy, copied as they
are: the fit's discrete choices hang on them), and the loss is a smooth,
symmetric soft-Chamfer distance in log-frequency between the predicted
mode frequencies and those peaks: no STFT of the prediction, so none of
the spectral-leakage ripple of a spectrogram loss.  Modes above Nyquist
appear in sampled audio at |f - sr round(f / sr)|, so predictions are
folded before matching.
"""

from __future__ import annotations

import numpy as np
import torch


def _blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris: -92 dB sidelobes (Hann: -31 dB)."""
    k = np.arange(n)
    w = 2.0 * np.pi * k / max(n - 1, 1)
    return (0.35875 - 0.48829 * np.cos(w) + 0.14128 * np.cos(2 * w)
            - 0.01168 * np.cos(3 * w))


def extract_spectral_peaks(
    audio: np.ndarray,
    sr: float,
    n_fft: int = 4096,
    top_k: int = 32,
    floor_db: float = 80.0,
    weight_power: float = 0.25,
    window: str = "blackmanharris",
):
    """Host-side modal-peak extraction from target audio.

    audio (T,) or (A, T) -> (freqs (P,), weights (P,)), P <= top_k,
    sorted by frequency.  Peaks are local maxima of the time-averaged
    log-magnitude STFT, refined by parabolic interpolation; weights are
    magnitudes compressed by weight_power, then normalized (raw magnitudes
    span about three decades between the fundamental and the heavily
    damped top modes).

    n_fft=None: one window spanning the whole signal, zero-padded 2x for
    peak interpolation (resolves near-Nyquist mode crowding).  The window
    is applied at the signal's length and the padding appended after it.

    window: "blackmanharris" (default) or "hann"."""
    x = np.atleast_2d(np.asarray(audio, np.float64))  # (A, T)
    T = x.shape[1]
    win_fn = _blackman_harris if window == "blackmanharris" else np.hanning
    if n_fft is None:
        win_len = T
        n_fft = min(1 << int(np.ceil(np.log2(2 * T))), 65536)
    else:
        # a signal shorter than the frame gets a signal-length window, then
        # zero padding: padding before windowing would show the signal only
        # the rising half of the window, whose leakage makes spurious peaks
        win_len = min(n_fft, T)
    hop = win_len // 4
    win = win_fn(win_len)
    n_frames = max(1, (T - win_len) // hop + 1)
    acc = np.zeros(n_fft // 2 + 1)
    # average magnitude spectra over channels and frames: averaging the
    # waveforms would let the channels' modal phases cancel
    for ch in x:
        for i in range(n_frames):
            fr = ch[i * hop : i * hop + win_len]
            if len(fr) < win_len:
                fr = np.pad(fr, (0, win_len - len(fr)))
            fr = fr * win
            if n_fft > win_len:
                fr = np.pad(fr, (0, n_fft - win_len))
            acc += np.abs(np.fft.rfft(fr))
    mag = acc / (n_frames * x.shape[0])
    logm = 20.0 * np.log10(mag + 1e-12)
    thresh = logm.max() - floor_db
    # strict local maxima above the floor, skipping DC/Nyquist edges
    cand = [
        k
        for k in range(2, len(mag) - 2)
        if logm[k] > thresh and logm[k] >= logm[k - 1] and logm[k] > logm[k + 1]
    ]
    cand.sort(key=lambda k: -mag[k])
    picked = []
    # min separation scales with the window's mainlobe in padded bins
    lobe = 4 if window == "blackmanharris" else 2
    min_sep = max(2, lobe * n_fft // win_len // 2)
    for k in cand:
        if all(abs(k - p) > min_sep for p in picked):
            picked.append(k)
        if len(picked) >= top_k:
            break
    if not picked:
        return np.zeros((0,)), np.zeros((0,))
    freqs, weights = [], []
    for k in sorted(picked):
        # parabolic interpolation on the log magnitude
        a, b, c = logm[k - 1], logm[k], logm[k + 1]
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        delta = float(np.clip(delta, -0.5, 0.5))
        freqs.append((k + delta) * sr / n_fft)
        weights.append(mag[k])
    freqs = np.asarray(freqs)
    weights = np.asarray(weights) ** weight_power
    return freqs, weights / weights.sum()


def union_peaks(peak_sets, merge_tol: float = 3e-3):
    """Merge several (freqs, weights) extractions into one deduplicated
    peak set: peaks within merge_tol in log-frequency collapse to the
    position of the heavier one with the max weight (each set is already
    normalized, so max, not sum, keeps a peak every window sees from
    counting thrice).  Returns (freqs, weights), weights renormalized."""
    fs, ws = [], []
    for f, w in peak_sets:
        fs.extend(np.asarray(f).tolist())
        ws.extend(np.asarray(w).tolist())
    if not fs:
        return np.zeros((0,)), np.zeros((0,))
    order = np.argsort(fs)
    fs = np.asarray(fs)[order]
    ws = np.asarray(ws)[order]
    out_f, out_w = [fs[0]], [ws[0]]
    for f, w in zip(fs[1:], ws[1:]):
        if np.log(f) - np.log(out_f[-1]) < merge_tol:
            if w > out_w[-1]:
                out_f[-1], out_w[-1] = f, w
        else:
            out_f.append(f)
            out_w.append(w)
    w = np.asarray(out_w)
    return np.asarray(out_f), w / w.sum()


def peak_coverage_score(pred_freqs, peaks, weights, sr: float,
                        tol: float = 5e-3):
    """Weighted fraction of peaks matched by a predicted mode within `tol`
    in log-frequency (predictions Nyquist-folded), minus a small
    mean-distance tiebreak.  The arbitration metric between extraction
    schemes: a correct fit lands every peak at < 1e-3, a wrong-basin fit
    misses whole peaks by > 1e-2.  Host-side numpy."""
    f = np.asarray(pred_freqs, np.float64)
    f = np.abs(f - sr * np.round(f / sr))
    lf = np.log(np.maximum(f, 20.0))
    lp = np.log(np.maximum(np.asarray(peaks, np.float64), 20.0))
    w = np.asarray(weights, np.float64)
    d = np.abs(lp[:, None] - lf[None, :]).min(axis=1)  # per peak
    matched = d < tol
    return float(np.sum(w * matched) - np.mean(np.minimum(d, 0.1)))


def fold_nyquist(f: torch.Tensor, sr: float) -> torch.Tensor:
    """Apparent frequency of a sampled sinusoid, |f - sr round(f / sr)|.
    Piecewise linear with derivative +-1 (0 at r = 0, as JAX's sign(r) r);
    the rounding carries no gradient."""
    k = torch.round(f.detach() / sr)
    return torch.abs(f - sr * k)


def _softmin(d: torch.Tensor, tau: float) -> torch.Tensor:
    """Smooth minimum over the last axis: -tau logsumexp(-d / tau)."""
    return -tau * torch.logsumexp(-d / tau, dim=-1)


def freq_chamfer_loss(
    pred_freqs: torch.Tensor,
    peak_freqs,
    peak_weights,
    sr: float,
    tau: float = 2e-3,
    fold: bool = True,
    f_floor: float = 20.0,
) -> torch.Tensor:
    """Symmetric soft-Chamfer distance in log-frequency.

    pred_freqs (..., M) differentiable; peak_freqs/weights (P,) constants
    (tensors or numpy).  One term pulls every extracted peak toward its
    soft-nearest predicted mode, magnitude-weighted; the other pulls every
    predicted mode toward its nearest peak.  tau is the squared-log-distance
    softmin temperature (2e-3: about a 4.5% frequency scale)."""
    f = pred_freqs.reshape(-1)
    if fold:
        f = fold_nyquist(f, sr)
    lf = torch.log(torch.clamp(f, min=f_floor))
    as_t = lambda x: torch.as_tensor(x, dtype=lf.dtype, device=lf.device)
    lp = torch.log(torch.clamp(as_t(peak_freqs), min=f_floor))
    w = as_t(peak_weights)
    d = (lf[:, None] - lp[None, :]) ** 2  # (M, P)
    loss_peaks = (w * _softmin(d.T, tau)).sum()  # peaks covered by modes
    loss_modes = _softmin(d, tau).mean()  # modes anchored to peaks
    return loss_peaks + loss_modes
