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


def multipair_state_from_jax(params_b: dict, opt_state: dict, lr: float, device="cpu",
                             dtype=PARAM_DTYPE):
    """JAX `MultipairTrainer` state -> the port's: params_b, the (B, K)
    logits `MultipairTrainer.init` returns (numpy leaves), and the vmapped
    optax Adam state as numpy, {"mu": {...}, "nu": {...}, "count": (B,)}
    (optax's `ScaleByAdamState` fields).  Returns (params_b, opt_b): leaf
    tensors on `device` and a torch.optim.Adam over them at `lr` whose
    first and second moments and step count are optax's (the count is one
    number per tensor in torch; every pair's count must agree)."""
    params = params_from_jax(params_b, device, dtype)
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    count = np.unique(np.asarray(opt_state["count"]))
    if count.size != 1:
        raise ValueError(f"the pairs' Adam step counts differ: {count}")
    for k, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count[0])),
            "exp_avg": torch.tensor(np.asarray(opt_state["mu"][k]), dtype=dtype, device=device),
            "exp_avg_sq": torch.tensor(np.asarray(opt_state["nu"][k]), dtype=dtype,
                                       device=device),
        }
    return params, opt


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


def _dense_from_flax(mlp: dict, as_t) -> dict:
    """flax's {"params": {"Dense_i": {"kernel" (in, out), "bias"}}} -> an
    `SDFNet` parameter dict {"layers.i.weight" (out, in), "layers.i.bias"}."""
    dense = mlp["params"]
    out = {}
    for i in range(len(dense)):
        out[f"layers.{i}.weight"] = as_t(np.asarray(dense[f"Dense_{i}"]["kernel"]).T)
        out[f"layers.{i}.bias"] = as_t(dense[f"Dense_{i}"]["bias"])
    return out


def sdf_params_from_jax(mlp: dict, deform, device="cpu", dtype=torch.float64) -> dict:
    """JAX `SDFGeometry` params -> the port's: flax's MLP params (numpy
    leaves) and `deform` (V, 3) -> {"mlp": {"layers.i.weight" (out, in),
    "layers.i.bias"}, "deform"} as leaf tensors on `device`."""
    as_t = lambda x: torch.tensor(np.array(x), dtype=dtype, device=device)
    return {"mlp": _dense_from_flax(mlp, as_t), "deform": as_t(deform)}


def joint_params_from_jax(params: dict, device="cpu") -> dict:
    """JAX `JointImageAudioTask` params (numpy leaves) -> the port's, for
    whichever of the groups are present, in the JAX package's dtypes: "geo"
    ({"front", "back"}: flax MLPs in float32; "deform" in float64), "tex" (a
    list of {"w" (in, out), "b"}) and "light" ({"base"}) in float32."""
    out = {}
    f32 = lambda x: torch.tensor(np.array(x), dtype=torch.float32, device=device)
    if "geo" in params:
        g = params["geo"]
        out["geo"] = {"front": _dense_from_flax(g["front"], f32),
                      "back": _dense_from_flax(g["back"], f32),
                      "deform": torch.tensor(np.array(g["deform"]), dtype=torch.float64,
                                             device=device)}
    if "tex" in params:
        out["tex"] = {}
        for i, layer in enumerate(params["tex"]):
            out["tex"][f"layers.{i}.weight"] = f32(np.asarray(layer["w"]).T)
            out["tex"][f"layers.{i}.bias"] = f32(layer["b"])
    if "light" in params:
        out["light"] = {"base": f32(params["light"]["base"])}
    return out


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


def entry_args_from_jax(args, device="cpu", dtype=PARAM_DTYPE):
    """The arguments of `__graft_entry__.py::entry` (params, eigenvalues,
    eigenvectors, gt_audio, forces), as numpy, -> the port's `entry`
    arguments: the params as leaf tensors, the rest as tensors, all of
    `dtype` on `device`."""
    params, *arrays = args
    as_t = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return (params_from_jax(params, device, dtype), *(as_t(x) for x in arrays))
