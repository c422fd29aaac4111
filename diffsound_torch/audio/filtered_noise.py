"""DDSP-style time-varying filtered noise.

Counterpart of `diffsound_tpu/audio/filtered_noise.py`: trainable per-frame
zero-phase filter banks become Hann-windowed linear-phase FIRs, are
FFT-convolved with frames of white noise and overlap-added.  The overlap-add
is a sum of shifted, zero-padded slabs of whole hops, with no scatter: on
CUDA `index_add_` reduces by atomics, whose order is not fixed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .oscillator import modified_sigmoid, uniform


@dataclass(frozen=True)
class FilteredNoise:
    noise_num: int
    sample_num: int
    filter_coeff_length: int = 65
    frame_length: int = 64
    attenuate_gain: float = 1.0

    @property
    def frame_num(self):
        return self.sample_num // self.frame_length + 1

    def init_params(self, generator: torch.Generator, dtype=torch.float32):
        shape = (self.noise_num, self.frame_num, self.filter_coeff_length)
        return {"coeff_bank": uniform(generator, shape, -1.0, 1.0, dtype)}

    def white_noise(self, generator: torch.Generator, dtype=torch.float32):
        """U[-1, 1) frames (noise_num, frame_num, frame_length) on the
        generator's device."""
        shape = (self.noise_num, self.frame_num, self.frame_length)
        return uniform(generator, shape, -1.0, 1.0, dtype)

    def __call__(self, params, generator=None, noise=None):
        """(noise_num, sample_num) filtered noise.  The white noise is
        `noise` when given (noise_num, frame_num, frame_length), else drawn
        from `generator` (one seeded 0 when None)."""
        x = modified_sigmoid(params["coeff_bank"])  # (B, Fr, C)
        B, Fr, C = x.shape
        L = self.frame_length
        ir_len = 2 * C - 1
        # zero-phase -> causal linear-phase FIR, symmetric-Hann-windowed; the
        # real half spectrum's irfft is that of its complex cast
        zero_phase = torch.fft.irfft(x, n=ir_len, dim=-1)
        win = torch.hann_window(ir_len, periodic=False, dtype=x.dtype, device=x.device)
        fir = torch.roll(zero_phase, C - 1, dims=-1) * win

        if noise is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            noise = self.white_noise(generator, x.dtype)
        noise = noise.to(device=x.device, dtype=x.dtype)

        # linear convolution of each frame by FFT
        out_len = L + ir_len - 1
        nfft = 1 << (out_len - 1).bit_length()
        conv = torch.fft.irfft(
            torch.fft.rfft(noise, n=nfft, dim=-1) * torch.fft.rfft(fir, n=nfft, dim=-1),
            n=nfft, dim=-1,
        )[..., :out_len] * self.attenuate_gain

        # overlap-add with hop L: frame f's output covers hops f .. f + k - 1;
        # its s-th hop-long slab, shifted by s frames, lands on hop f + s.
        # Slabs are summed from the last (the earliest frame) to the first.
        k = -(-out_len // L)
        conv = F.pad(conv, (0, k * L - out_len)).reshape(B, Fr, k, L)
        out = sum(F.pad(conv[:, :, s], (0, 0, s, k - 1 - s)) for s in reversed(range(k)))
        return out.reshape(B, -1)[:, : self.sample_num]
