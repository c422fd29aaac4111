"""Carry parameters and eigen-data across from the JAX package as numpy.

The port never imports `diffsound_tpu`; callers (the parity tests, or a
user moving a run between the packages) hand over plain numpy arrays, e.g.
`{k: np.asarray(v) for k, v in jax_params.items()}`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.material_model import PARAM_DTYPE
from .models.sound_obj import EigenState, ModalCache


def params_from_jax(params: dict, device="cpu", dtype=PARAM_DTYPE) -> dict:
    """JAX `MaterialBins` params (dict of numpy logits) -> the port's dict
    of leaf tensors on `device` (float32 like the trainers' params; the
    parity tests pass float64 to compare the chain above f32 roundoff)."""
    return {
        k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in params.items()
    }


def osc_params_from_jax(params: dict, device="cpu", dtype=PARAM_DTYPE) -> dict:
    """JAX `OscillatorBank` or `GTOscillatorBank` params (numpy leaves; the
    GT bank nests its noise params as {"noise": {"coeff_bank": x}}) -> the
    port's flat dict of leaf tensors on `device` ("noise_coeff_bank")."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}_{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    return params_from_jax(flat, device, dtype)


def sdf_params_from_jax(mlp: dict, deform, device="cpu", dtype=torch.float64) -> dict:
    """JAX `SDFGeometry` params -> the port's: flax's
    {"params": {"Dense_i": {"kernel" (in, out), "bias"}}} (numpy leaves) and
    `deform` (V, 3) -> {"mlp": {"layers.i.weight" (out, in), "layers.i.bias"},
    "deform"} as leaf tensors on `device`."""
    as_t = lambda x: torch.tensor(np.array(x), dtype=dtype, device=device)
    dense = mlp["params"]
    out = {}
    for i in range(len(dense)):
        out[f"layers.{i}.weight"] = as_t(np.asarray(dense[f"Dense_{i}"]["kernel"]).T)
        out[f"layers.{i}.bias"] = as_t(dense[f"Dense_{i}"]["bias"])
    return {"mlp": out, "deform": as_t(deform)}


def eigen_state_from_numpy(eigenvalues, eigenvectors, dtype, device="cpu",
                           iterations: int = 0, residual=None) -> EigenState:
    vals = torch.as_tensor(np.asarray(eigenvalues), dtype=dtype, device=device)
    res = (
        torch.zeros_like(vals) if residual is None
        else torch.as_tensor(np.asarray(residual), dtype=dtype, device=device)
    )
    return EigenState(
        vals, torch.as_tensor(np.asarray(eigenvectors), dtype=dtype, device=device),
        int(iterations), res,
    )


def modal_cache_from_numpy(eigenvalues, q_mu, q_lam, q_m, dtype,
                           device="cpu") -> ModalCache:
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return ModalCache(as_t(eigenvalues), as_t(q_mu), as_t(q_lam), as_t(q_m))
