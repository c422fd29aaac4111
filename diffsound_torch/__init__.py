"""diffsound-torch: the PyTorch/CUDA port of diffsound-tpu for NVIDIA Hopper.

Module paths mirror `diffsound_tpu` (``diffsound_torch/fem/assembly.py`` is
the counterpart of ``diffsound_tpu/fem/assembly.py``).  The package imports
torch, numpy and scipy only; the one Pallas kernel of the JAX package (the
fused oscillator-bank synthesis) is a hand-written CUDA kernel here
(`audio/synth_kernel.py`, `csrc/synth.cu`).

Devices: every entry point takes ``device=`` and defaults to ``"cuda"``; with
no GPU it raises instead of running on the CPU.  The CPU (``device="cpu"``)
is for tests and validation and runs in float64; CUDA runs in float32.

Precision: TF32 is switched off at import.  FEM nodal forces are sums that
cancel about 100-fold, and TF32's 10-bit mantissa turns that into O(1)
Rayleigh-quotient error, just as bf16 did on the TPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device``; raises when CUDA is asked for and
    absent (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diffsound_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def default_dtype(device="cuda") -> torch.dtype:
    """f64 on CPU (validation), f32 on CUDA (production)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
