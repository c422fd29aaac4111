"""Damped modal oscillator banks and additive audio synthesis.

Counterpart of `diffsound_tpu/audio/oscillator.py`:
`TraditionalOscillatorParams` (fixed Rayleigh alpha/beta), `OscillatorBank`
(trainable per-mode alpha/beta over 64 log bins and amplitudes; its
`forward_curve` takes the damping from an extracted damping curve) and
`GTOscillatorBank` (trainable frequencies, wide alpha/beta bins, amplitudes
and filtered noise: the real-audio stage-1 fit).  Per-mode damping and
frequency are constant over time, so

    signal[n] = sum_m amp_m * exp(-d_m (n+1) dt) * sin(2 pi f_m (n+1) dt)

is evaluated in closed form: on CUDA by the hand-written kernel of
`audio/synth_kernel.py`, on the CPU by its plain version.  The force
excitation is applied as an FFT convolution.  `synth_time_varying` is the
inclusive-cumsum path of the GT bank's per-sample nonlinear frequency
option (plain torch, as it is XLA in the JAX package).

Parameters are dicts of leaf tensors drawn from an explicit
`torch.Generator`, on the generator's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
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


def log_bins(center: float, lo_factor: float, hi_factor: float, num: int):
    """num values spaced evenly in log between center*lo and center*hi."""
    return np.exp(
        np.linspace(np.log(center * lo_factor), np.log(center * hi_factor), num)
    )


def uniform(generator: torch.Generator, shape, lo: float, hi: float,
            dtype=torch.float32) -> torch.Tensor:
    """U[lo, hi) draws on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return u * (hi - lo) + lo


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


def synth_time_varying(freqs, damps, amps, sr: float, forces=None):
    """Per-sample freq/damp (A, M, T) -> (A, T): the inclusive cumsum of
    the phase and the decay, summed over modes."""
    damp_int = torch.cumsum(damps / sr, dim=-1)
    freq_int = torch.cumsum(freqs / sr, dim=-1)
    sig = (amps * torch.exp(-damp_int) * torch.sin(2.0 * math.pi * freq_int)).sum(dim=-2)
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


def cached_values(cache: dict, name: str, values: np.ndarray, like: torch.Tensor):
    """`values` as a tensor of like's dtype and device, made once per cache:
    a fresh copy from host memory in every step would make the host wait."""
    key = (name, like.dtype, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    return cache[key]


@dataclass(frozen=True)
class OscillatorBank:
    """Trainable per-mode Rayleigh damping (64 log bins from 0.1x to 10x the
    table's alpha and beta) and per-(audio, mode) amplitudes.

    Params: {"alpha_logits": (M, 64), "beta_logits": (M, 64),
             "amp_raw": (A, M)}."""

    audio_num: int
    mode_num: int
    sample_num: int
    sr: float
    mat: Material
    bin_num: int = 64
    alpha_values: np.ndarray = field(default=None)
    beta_values: np.ndarray = field(default=None)
    _tensors: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(
            self, "alpha_values", log_bins(self.mat.alpha, 0.1, 10.0, self.bin_num)
        )
        object.__setattr__(
            self, "beta_values", log_bins(self.mat.beta, 0.1, 10.0, self.bin_num)
        )

    def init_params(self, generator: torch.Generator, dtype=torch.float32):
        M, K = self.mode_num, self.bin_num
        return {
            "alpha_logits": uniform(generator, (M, K), -4.0, 4.0, dtype),
            "beta_logits": uniform(generator, (M, K), -4.0, 4.0, dtype),
            "amp_raw": uniform(generator, (self.audio_num, M), 0.0, 0.04, dtype),
        }

    def alpha(self, params):
        lg = params["alpha_logits"]
        return weighted_value(lg, cached_values(self._tensors, "alpha", self.alpha_values, lg))

    def beta(self, params):
        lg = params["beta_logits"]
        return weighted_value(lg, cached_values(self._tensors, "beta", self.beta_values, lg))

    def __call__(self, params, undamped_freq, forces=None):
        """undamped_freq (M,) -> (signal (A, T), damped_freq (M,))."""
        amps = modified_sigmoid(params["amp_raw"])
        f = undamped_freq.reshape(1, self.mode_num).to(amps.dtype)
        lbd = (2.0 * math.pi * f) ** 2
        damp = rayleigh_damping(self.alpha(params)[None, :], self.beta(params)[None, :], lbd)
        fd = damped_frequency(f, damp)
        sig = synth_constant_modes(fd.expand(amps.shape), damp.expand(amps.shape), amps,
                                   self.sample_num, self.sr, forces)
        return sig, fd[0]

    def forward_curve(self, params, undamped_freq, curve_damp, forces=None):
        """Synthesis with unit amplitudes and the damping of an extracted
        damping curve, curve_damp (M,) (evaluated on the host), each audio
        row divided by its detached max |signal|.  Only amp_raw's dtype is
        used of the params."""
        dtype = params["amp_raw"].dtype
        shape = (self.audio_num, self.mode_num)
        f = undamped_freq.reshape(1, self.mode_num).to(dtype)
        damp = curve_damp.reshape(1, -1).to(dtype).expand(f.shape)
        fd = damped_frequency(f, damp)
        amps = torch.ones(shape, dtype=dtype, device=f.device)
        sig = synth_constant_modes(fd.expand(shape), damp.expand(shape), amps,
                                   self.sample_num, self.sr, forces)
        sig = sig / sig.detach().abs().amax(dim=1, keepdim=True)
        return sig, fd[0]

    def pretrain_damps(self, params, steps: int = 2000, lr: float = 0.01):
        """Adam-fit the alpha/beta logits so the weighted values hit the
        table's alpha and beta; returns a new params dict of detached
        tensors.  A Python loop of `steps` small steps on the params'
        device (the JAX package's is one scanned program)."""
        ta, tb = self.mat.alpha, self.mat.beta
        p = {k: params[k].detach().clone().requires_grad_(True)
             for k in ("alpha_logits", "beta_logits")}
        opt = torch.optim.Adam(list(p.values()), lr=lr)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            a, b = self.alpha(p), self.beta(p)
            ((a - ta) ** 2 / ta**2 + (b - tb) ** 2 / tb**2).mean().backward()
            opt.step()
        return {**{k: v.detach() for k, v in params.items()},
                **{k: v.detach() for k, v in p.items()}}


@dataclass(frozen=True)
class GTOscillatorBank:
    """Fully trainable oscillator fit to recordings to extract a damping
    curve: linear frequencies over f_range, alpha/beta over wider bins
    (0.1x to 100x the table), amplitudes and filtered noise; optionally a
    per-sample nonlinear frequency term.

    Params: {"freq_logits": (M, 2), "alpha_logits": (M, 64),
    "beta_logits": (M, 64), "amp_raw": (A, M), "noise_coeff_bank": (A,
    frames, 65)} and, with use_nonlinear, "nl_freq_logits": (A, M, T, 2).
    The JAX package nests the noise params as {"noise": {"coeff_bank"}};
    `convert.osc_params_from_jax` flattens them."""

    audio_num: int
    mode_num: int
    sample_num: int
    sr: float
    mat: Material
    f_range: tuple = (20.0, 16000.0)
    bin_num: int = 64
    use_nonlinear: bool = False
    _tensors: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def noise(self):
        from .filtered_noise import FilteredNoise

        return FilteredNoise(self.audio_num, self.sample_num)

    def init_params(self, generator: torch.Generator, dtype=torch.float32):
        """Draws in the JAX package's order: freq, alpha, beta, amp, noise,
        then the nonlinear logits when use_nonlinear."""
        M, K = self.mode_num, self.bin_num
        params = {
            "freq_logits": uniform(generator, (M, len(self.f_range)), -4.0, 4.0, dtype),
            "alpha_logits": uniform(generator, (M, K), -4.0, 4.0, dtype),
            "beta_logits": uniform(generator, (M, K), -4.0, 4.0, dtype),
            "amp_raw": uniform(generator, (self.audio_num, M), 0.0, 0.04, dtype),
            "noise_coeff_bank": self.noise().init_params(generator, dtype)["coeff_bank"],
        }
        if self.use_nonlinear:
            # (A, M, T, 2): the dominant parameter block, made only on request
            params["nl_freq_logits"] = uniform(
                generator, (self.audio_num, M, self.sample_num, len(self.f_range)),
                -4.0, 4.0, dtype)
        return params

    def _values(self, name, like):
        if name == "freq":
            values = np.asarray(self.f_range, dtype=np.float64)
        else:
            center = self.mat.alpha if name == "alpha" else self.mat.beta
            values = log_bins(center, 0.1, 100.0, self.bin_num)
        return cached_values(self._tensors, name, values, like)

    def freq_linear(self, params):
        lg = params["freq_logits"]
        return weighted_value(lg, self._values("freq", lg))  # (M,)

    def _alpha_beta(self, params, like):
        return (weighted_value(params["alpha_logits"], self._values("alpha", like)),
                weighted_value(params["beta_logits"], self._values("beta", like)))

    def damping(self, params):
        """Per-mode damping at the linear frequency (M,)."""
        f = self.freq_linear(params)
        a, b = self._alpha_beta(params, f)
        return rayleigh_damping(a, b, (2.0 * math.pi * f) ** 2)

    def __call__(self, params, forces=None, noise_rate: float = 0.0, generator=None,
                 non_linear_rate: float = 0.0, noise=None):
        """-> (signal (A, T), damped frequency (M,)).  With noise_rate > 0
        the filtered noise is added, its white noise drawn from `generator`
        or given as `noise` (see FilteredNoise.__call__)."""
        amps = modified_sigmoid(params["amp_raw"])
        dtype = amps.dtype
        f = self.freq_linear(params).reshape(1, self.mode_num).to(dtype)
        a, b = (x[None, :] for x in self._alpha_beta(params, amps))
        if non_linear_rate > 0.0 and "nl_freq_logits" in params:
            # undamped freq = linear + rate * per-sample deviation: damping
            # and damped frequency vary per sample, so the synthesis takes
            # the cumsum recurrence instead of the closed form
            f_nl = weighted_value(params["nl_freq_logits"], self._values("freq", amps))
            lbd = (2.0 * math.pi * (f[..., None] + non_linear_rate * f_nl)) ** 2
            damp = rayleigh_damping(a[..., None], b[..., None], lbd)
            fd = torch.sqrt(torch.clamp(lbd - damp**2, min=1e-12)) / (2.0 * math.pi)
            sig = synth_time_varying(fd, damp, amps[..., None], self.sr, forces)
            fd_report = fd[0].mean(dim=-1)
        else:
            damp = rayleigh_damping(a, b, (2.0 * math.pi * f) ** 2)
            fd = damped_frequency(f, damp)
            sig = synth_constant_modes(fd.expand(amps.shape), damp.expand(amps.shape), amps,
                                       self.sample_num, self.sr, forces)
            fd_report = fd[0]
        if noise_rate > 0.0:
            sig = sig + noise_rate * self.noise()(
                {"coeff_bank": params["noise_coeff_bank"]}, generator, noise)
        return sig, fd_report


def synth_signal(freqs, damps, amps, num_samples, sr, forces=None):
    """Alias of `synth_constant_modes`."""
    return synth_constant_modes(freqs, damps, amps, num_samples, sr, forces)
