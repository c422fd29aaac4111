"""Damped modal oscillators and additive audio synthesis.

Counterpart of `diffsound_tpu/audio/oscillator.py` for the main path:
`TraditionalOscillatorParams` (fixed Rayleigh alpha/beta) and the helpers it
uses.  Per-mode damping and frequency are constant over time, so

    signal[n] = sum_m amp_m * exp(-d_m (n+1) dt) * sin(2 pi f_m (n+1) dt)

is evaluated in closed form: on CUDA by the hand-written kernel of
`audio/synth_kernel.py`, on the CPU by its plain version.  The force
excitation is applied as an FFT convolution.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..fem.material import Material
from .synth_kernel import SynthFn, synth_constant_modes_plain


def modified_sigmoid(x):
    """2 * sigmoid(x)^2.3 + 1e-6."""
    return 2.0 * torch.sigmoid(x) ** 2.3 + 1e-6


def weighted_value(logits, values):
    """Softplus-normalized convex combination over a fixed value list:
    logits (..., K), values (K,) -> (...)."""
    w = F.softplus(logits)
    w = w / w.sum(dim=-1, keepdim=True)
    return (w * values).sum(dim=-1)


def fft_convolve_force(signal: torch.Tensor, forces: torch.Tensor) -> torch.Tensor:
    """Causal convolution of per-channel signals with per-channel force
    excitation, truncated to the signal length.

    signal (A, T), forces (A, F) -> (A, T);
    out[a, n] = sum_k forces[a, k] * signal[a, n - k].
    """
    T = signal.shape[-1]
    n = T + forces.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    S = torch.fft.rfft(signal, n=nfft, dim=-1)
    K = torch.fft.rfft(forces, n=nfft, dim=-1)
    out = torch.fft.irfft(S * K, n=nfft, dim=-1)
    return out[:, :T].to(signal.dtype)


def synth_constant_modes(
    freqs: torch.Tensor,
    damps: torch.Tensor,
    amps: torch.Tensor,
    num_samples: int,
    sr: float,
    forces: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Additive synthesis with time-constant per-mode damped freq/damping.

    freqs, damps: (A, M) damped frequency [Hz] and damping [1/s];
    amps: (A, M); forces: optional (A, F).  Returns (A, num_samples).

    CUDA float32 always goes through the hand-written kernel (`SynthFn`);
    CPU tensors take the plain version; anything else raises."""
    if amps.is_cuda:
        if not all(x.dtype == torch.float32 for x in (freqs, damps, amps)):
            raise TypeError(
                "synth_constant_modes: CUDA synthesis runs the float32 kernel; got "
                f"{freqs.dtype}/{damps.dtype}/{amps.dtype}"
            )
        sig = SynthFn.apply(
            freqs.contiguous(), damps.contiguous(), amps.contiguous(), num_samples, sr
        )
    elif amps.device.type == "cpu":
        sig = synth_constant_modes_plain(freqs, damps, amps, num_samples, sr)
    else:
        raise ValueError(f"synth_constant_modes: unsupported device {amps.device}")
    if forces is not None:
        sig = fft_convolve_force(sig, forces.to(sig.dtype))
    return sig


def rayleigh_damping(alpha, beta, lbd):
    """d = (alpha + beta * lambda) / 2 for lambda = (2 pi f)^2."""
    return 0.5 * (alpha + beta * lbd)


def damped_frequency(undamped_freq, damp):
    """f_d = sqrt(lambda - d^2) / 2 pi."""
    lbd = (2.0 * math.pi * undamped_freq) ** 2
    return torch.sqrt(torch.clamp(lbd - damp**2, min=1e-12)) / (2.0 * math.pi)


@dataclass(frozen=True)
class TraditionalOscillatorParams:
    """Fixed-table Rayleigh damping synthesizer (ground truth and the
    synthetic-material synth)."""

    audio_num: int
    mode_num: int
    sample_num: int
    sr: float
    mat: Material

    def __call__(self, undamped_freq, forces=None, dtype=torch.float32):
        """undamped_freq (M,) -> (signal (A, T), damped_freq (M,))."""
        f = undamped_freq.reshape(1, self.mode_num).expand(
            self.audio_num, self.mode_num
        ).to(dtype)
        lbd = (2.0 * math.pi * f) ** 2
        damp = rayleigh_damping(self.mat.alpha, self.mat.beta, lbd)
        fd = damped_frequency(f, damp)
        amps = torch.ones_like(f)
        sig = synth_constant_modes(fd, damp, amps, self.sample_num, self.sr, forces)
        return sig, fd[0]
