"""Hand-written CUDA kernels for the damped oscillator-bank synthesis and its
backward, their wrappers, the autograd function, and the plain PyTorch
versions.

    out[a, t] = sum_m amp[a, m] * exp(-d[a, m] (t+1)/sr) * sin(2 pi frac(f[a, m] (t+1)/sr))

Replaces `diffsound_tpu/audio/pallas_osc.py::_synth_kernel` (the JAX
package's only Pallas kernel).  The source is `csrc/synth.cu`; it is built
with nvcc for sm_90a into `diffsound_torch/build/` at first use (rebuilt
when the source hash changes) and loaded with ctypes.

* `synth_kernel` launches the kernel for CUDA float32 tensors (and raises on
  anything else on the GPU); for CPU tensors it returns the plain version.
* `synth_kernel_bwd` launches the backward kernel, (A, T) cotangent ->
  (grad_f, grad_d, grad_amp), for CUDA tensors; for CPU tensors it returns
  the plain version.
* `SynthFn` is the autograd function over the two wrappers: both kernels on
  CUDA, both plain versions on the CPU.
* `synth_constant_modes_plain` is the port of
  `oscillator.py::_synth_constant_modes_xla`, and
  `synth_constant_modes_bwd_plain` its vector-Jacobian product as direct
  sums: the tests and the on-card comparison use them; the CUDA main path
  does not.
* `LAUNCHES` and `LAUNCHES_BWD` count launches of the forward and the
  backward kernel (one per call that reached the kernel).
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch

from ..utils import nvcc

SOURCE = os.path.join(nvcc.CSRC, "synth.cu")

LAUNCHES = 0
LAUNCHES_BWD = 0
BUILD_SECONDS = None  # wall time of the nvcc build in this process (None: loaded a cached build)

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile csrc/synth.cu unless a build of this exact source exists;
    returns the shared library's path.  Raises if nvcc fails."""
    global BUILD_SECONDS
    so, seconds = nvcc.build(SOURCE)
    if seconds is not None:
        BUILD_SECONDS = seconds
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, n_ptr in ((lib.synth_constant_modes_launch, 4),
                              (lib.synth_constant_modes_bwd_launch, 5)):
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                    ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def synth_constant_modes_plain(freqs, damps, amps, num_samples: int, sr: float):
    """Plain PyTorch synthesis, (A, M) -> (A, num_samples), with the phase
    frac(f (t+1)/sr) taken in float64 so long tails stay exact."""
    dtype, device = amps.dtype, amps.device
    n1 = torch.arange(num_samples, dtype=torch.float64, device=device) + 1.0
    t = (torch.arange(num_samples, dtype=torch.float32, device=device) + 1.0) / sr
    cycles = freqs.to(torch.float64)[..., None] * (n1 / sr)
    phase = 2.0 * math.pi * torch.remainder(cycles, 1.0)
    envelope = torch.exp(-damps[..., None] * t.to(dtype))
    sig = amps[..., None] * envelope * torch.sin(phase).to(dtype)
    return sig.sum(dim=-2)  # (A, T)


def synth_constant_modes_bwd_plain(freqs, damps, amps, g, num_samples: int, sr: float):
    """Plain PyTorch vector-Jacobian product of `synth_constant_modes_plain`:
    the (A, num_samples) cotangent g -> (grad_f, grad_d, grad_amp), each
    (A, M), as direct sums over t with the phase in float64.  The phase's
    time is (t+1)/sr in float64 and the envelope's the float32 one, as in
    the forward, so in float64 this is autograd of the forward."""
    dtype, device = amps.dtype, amps.device
    n1 = torch.arange(num_samples, dtype=torch.float64, device=device) + 1.0
    t = ((torch.arange(num_samples, dtype=torch.float32, device=device) + 1.0) / sr).to(dtype)
    phase = 2.0 * math.pi * torch.remainder(freqs.to(torch.float64)[..., None] * (n1 / sr), 1.0)
    ge = g.to(dtype)[:, None, :] * torch.exp(-damps[..., None] * t)  # (A, M, T)
    ge_sin = ge * torch.sin(phase).to(dtype)
    grad_amp = ge_sin.sum(dim=-1)
    grad_d = -amps * (ge_sin * t).sum(dim=-1)
    grad_f = (2.0 * math.pi) * amps * (ge * torch.cos(phase).to(dtype) * (n1 / sr).to(dtype)).sum(dim=-1)
    return grad_f, grad_d, grad_amp


def _check_cuda(fn_name, T, **tensors):
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device, (A, M) for the mode tables and (A, T) for g, inside the grid;
    returns (A, M)."""
    freqs = tensors["freqs"]
    if freqs.dim() != 2:
        raise ValueError(f"{fn_name}: freqs has shape {tuple(freqs.shape)}, expected (A, M)")
    A, M = freqs.shape
    for name, x in tensors.items():
        shape = (A, T) if name == "g" else (A, M)
        if not x.is_cuda:
            raise ValueError(f"{fn_name}: {name} is on {x.device}, expected CUDA")
        if x.dtype != torch.float32:
            raise TypeError(f"{fn_name}: {name} is {x.dtype}, the kernel takes float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"{fn_name}: {name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{fn_name}: {name} is not contiguous")
        if x.device != freqs.device:
            raise ValueError(f"{fn_name}: inputs on different devices")
    if A > 65535 or T >= 2**31 - 256:
        raise ValueError(f"{fn_name}: shape (A={A}, T={T}) outside the launch grid")
    return A, M


def synth_kernel(freqs, damps, amps, num_samples: int, sr: float):
    """(A, M) mode parameters -> (A, num_samples) signal.

    CUDA tensors: launches the hand-written kernel (float32, contiguous,
    (A, M) required; anything else raises).  CPU tensors: the plain
    version."""
    global LAUNCHES
    if all(x.device.type == "cpu" for x in (freqs, damps, amps)):
        return synth_constant_modes_plain(freqs, damps, amps, num_samples, sr)
    T = int(num_samples)
    A, M = _check_cuda("synth_kernel", T, freqs=freqs, damps=damps, amps=amps)
    lib = _load()
    out = torch.empty((A, T), dtype=torch.float32, device=freqs.device)
    with torch.cuda.device(freqs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.synth_constant_modes_launch(
            freqs.data_ptr(), damps.data_ptr(), amps.data_ptr(), out.data_ptr(),
            A, M, T, float(sr), stream,
        )
    if err != 0:
        raise RuntimeError(f"synth kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    return out


def synth_kernel_bwd(freqs, damps, amps, g, num_samples: int, sr: float):
    """(A, M) mode parameters and the (A, num_samples) cotangent g of the
    signal -> (grad_f, grad_d, grad_amp), each (A, M).

    CUDA tensors: launches the hand-written backward kernel (float32,
    contiguous, g of shape (A, num_samples); anything else raises).  CPU
    tensors: the plain version."""
    global LAUNCHES_BWD
    if all(x.device.type == "cpu" for x in (freqs, damps, amps, g)):
        return synth_constant_modes_bwd_plain(freqs, damps, amps, g, num_samples, sr)
    T = int(num_samples)
    A, M = _check_cuda("synth_kernel_bwd", T, freqs=freqs, damps=damps, amps=amps, g=g)
    lib = _load()
    grad = torch.empty((3, A, M), dtype=torch.float32, device=freqs.device)
    with torch.cuda.device(freqs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.synth_constant_modes_bwd_launch(
            freqs.data_ptr(), damps.data_ptr(), amps.data_ptr(), g.data_ptr(),
            grad.data_ptr(), A, M, T, float(sr), stream,
        )
    if err != 0:
        raise RuntimeError(f"synth backward kernel launch failed with cudaError {err}")
    LAUNCHES_BWD += 1
    return grad[0], grad[1], grad[2]


class SynthFn(torch.autograd.Function):
    """`synth_kernel` forward, `synth_kernel_bwd` backward: the kernels on
    CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, freqs, damps, amps, num_samples, sr):
        ctx.save_for_backward(freqs, damps, amps)
        ctx.num_samples, ctx.sr = num_samples, sr
        return synth_kernel(freqs, damps, amps, num_samples, sr)

    @staticmethod
    def backward(ctx, g):
        freqs, damps, amps = ctx.saved_tensors
        # out.sum() hands autograd an expanded, stride-0 g
        return (*synth_kernel_bwd(freqs, damps, amps, g.contiguous(), ctx.num_samples, ctx.sr),
                None, None)
