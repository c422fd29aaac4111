"""Hand-written CUDA kernel for the damped oscillator-bank synthesis, its
wrapper, its autograd function, and its plain PyTorch version.

    out[a, t] = sum_m amp[a, m] * exp(-d[a, m] (t+1)/sr) * sin(2 pi frac(f[a, m] (t+1)/sr))

Replaces `diffsound_tpu/audio/pallas_osc.py::_synth_kernel` (the JAX
package's only Pallas kernel).  The source is `csrc/synth.cu`; it is built
with nvcc for sm_90a into `diffsound_torch/build/` at first use (rebuilt
when the source hash changes) and loaded with ctypes.

* `synth_kernel` launches the kernel for CUDA float32 tensors (and raises on
  anything else on the GPU); for CPU tensors it returns the plain version.
* `SynthFn` is the autograd function: kernel forward, plain-version
  recompute backward (as `_synth_fused_bwd` does in the JAX package).
* `synth_constant_modes_plain` is the port of
  `oscillator.py::_synth_constant_modes_xla`: the tests, the backward and
  the on-card comparison use it; the CUDA main path does not.
* `LAUNCHES` counts kernel launches (one per call that reached the kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "synth.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = 0
BUILD_SECONDS = None  # wall time of the nvcc build in this process (None: loaded a cached build)

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: cannot build csrc/synth.cu")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsynth_{digest}.so")


def build() -> str:
    """Compile csrc/synth.cu unless a build of this exact source exists;
    returns the shared library's path.  Raises if nvcc fails."""
    global BUILD_SECONDS
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0
    with open(so + ".log", "w") as f:
        f.write(proc.stderr)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.synth_constant_modes_launch
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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


def synth_kernel(freqs, damps, amps, num_samples: int, sr: float):
    """(A, M) mode parameters -> (A, num_samples) signal.

    CUDA tensors: launches the hand-written kernel (float32, contiguous,
    (A, M) required; anything else raises).  CPU tensors: the plain
    version."""
    global LAUNCHES
    if all(x.device.type == "cpu" for x in (freqs, damps, amps)):
        return synth_constant_modes_plain(freqs, damps, amps, num_samples, sr)
    for name, x in (("freqs", freqs), ("damps", damps), ("amps", amps)):
        if not x.is_cuda:
            raise ValueError(f"synth_kernel: {name} is on {x.device}, expected CUDA")
        if x.dtype != torch.float32:
            raise TypeError(f"synth_kernel: {name} is {x.dtype}, the kernel takes float32")
        if x.dim() != 2 or x.shape != freqs.shape:
            raise ValueError(f"synth_kernel: {name} has shape {tuple(x.shape)}, expected (A, M) = {tuple(freqs.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"synth_kernel: {name} is not contiguous")
        if x.device != freqs.device:
            raise ValueError("synth_kernel: inputs on different devices")
    A, M = freqs.shape
    T = int(num_samples)
    if A > 65535 or T >= 2**31 - 256:
        raise ValueError(f"synth_kernel: shape (A={A}, T={T}) outside the launch grid")
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


class SynthFn(torch.autograd.Function):
    """Kernel forward; the backward recomputes the plain version under
    autograd and returns its vector-Jacobian product (the (A, M, T)
    intermediates exist only inside the backward)."""

    @staticmethod
    def forward(ctx, freqs, damps, amps, num_samples, sr):
        ctx.save_for_backward(freqs, damps, amps)
        ctx.num_samples, ctx.sr = num_samples, sr
        return synth_kernel(freqs, damps, amps, num_samples, sr)

    @staticmethod
    def backward(ctx, g):
        freqs, damps, amps = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(True) for x in (freqs, damps, amps)]
            out = synth_constant_modes_plain(*inputs, ctx.num_samples, ctx.sr)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)
