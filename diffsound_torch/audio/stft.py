"""Spectrograms on `torch.stft` (cuFFT on the GPU).

Same semantics as `diffsound_tpu.audio.stft.spectrogram` and
torchaudio's `Spectrogram(n_fft, hop_length)` defaults: periodic Hann window
of length n_fft, centered frames with reflect padding, power-2 magnitude.
The JAX package's slice-only framing and FFT custom VJPs were TPU
workarounds; autograd through `torch.stft` replaces them.
"""

from __future__ import annotations

import torch


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, power: float = 2.0):
    """(..., T) -> (..., n_fft//2 + 1, num_frames) magnitude^power.

    |X|^2 is taken as re^2 + im^2, so the gradient stays finite where the
    spectrum is exactly zero."""
    batch = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    window = torch.hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(
        x2, n_fft, hop_length=hop, win_length=n_fft, window=window, center=True,
        pad_mode="reflect", normalized=False, onesided=True, return_complex=True,
    )  # (B, bins, frames)
    mag2 = spec.real**2 + spec.imag**2
    if power != 2.0:
        mag2 = mag2 ** (power / 2.0)
    return mag2.reshape(*batch, *mag2.shape[-2:])
