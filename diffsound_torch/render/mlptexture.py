"""Neural volumetric texture: position -> (kd, ks, perturbed normal).

Counterpart of `diffsound_tpu/render/mlptexture.py::MLPTexture3D`: a sin/cos
positional encoding of the position normalised to the AABB, a ReLU MLP
(`layers` hidden layers of `hidden`), and a sigmoid into `min_max`.

The parameters are explicit, as in `geometry/sdf_mlp.py`: a dict
{"layers.i.weight" (out, in), "layers.i.bias"} applied through
`torch.func.functional_call` on a module whose own layers live on the meta
device.  Layer i's weight is the JAX package's params[i]["w"] transposed
(`convert.joint_params_from_jax`)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class MLPTexture3D(nn.Module):
    def __init__(self, aabb, channels: int = 9, freq_num: int = 6, hidden: int = 64,
                 layers: int = 3, min_max=None):
        super().__init__()
        self.aabb = (np.asarray(aabb[0], np.float32), np.asarray(aabb[1], np.float32))
        self.channels = channels
        self.freq_num = freq_num
        if min_max is None:
            # kd in [0,1]^3, ks (occlusion 0, roughness, metallic), normal in
            # [-1,1]^3: the nvdiffrec defaults
            min_max = (np.array([0, 0, 0, 0, 0.08, 0, -1, -1, -1], np.float32)[:channels],
                       np.array([1, 1, 1, 0, 1, 1, 1, 1, 1], np.float32)[:channels])
        self.min_max = (np.asarray(min_max[0], np.float32), np.asarray(min_max[1], np.float32))
        dims = [self.in_dim()] + [hidden] * layers + [channels]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device="meta") for a, b in zip(dims[:-1], dims[1:]))

    def in_dim(self):
        return 3 + 2 * 3 * self.freq_num

    def _encode(self, pos):
        lo = torch.as_tensor(self.aabb[0], dtype=pos.dtype, device=pos.device)
        hi = torch.as_tensor(self.aabb[1], dtype=pos.dtype, device=pos.device)
        x = (pos - lo) / (hi - lo) * 2.0 - 1.0
        freqs = 2.0 ** torch.arange(self.freq_num, dtype=pos.dtype, device=pos.device) * math.pi
        ang = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)  # (..., 3F)
        return torch.cat([x, torch.sin(ang), torch.cos(ang)], dim=-1)

    def forward(self, pos):
        h = self._encode(pos)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        h = self.layers[-1](h)
        lo = torch.as_tensor(self.min_max[0], dtype=h.dtype, device=h.device)
        hi = torch.as_tensor(self.min_max[1], dtype=h.dtype, device=h.device)
        return torch.sigmoid(h) * (hi - lo) + lo

    def sample(self, params: dict, pos):
        """pos (..., 3) world -> (..., channels) in min_max."""
        return torch.func.functional_call(self, params, (pos,))

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device="cpu") -> dict:
        """He-normal weights (std sqrt(2 / fan_in)), zero biases, drawn from
        `generator` (a CPU generator; the values move to `device`)."""
        params = {}
        for i, layer in enumerate(self.layers):
            w = torch.randn((layer.out_features, layer.in_features), generator=generator,
                            dtype=dtype) * math.sqrt(2.0 / layer.in_features)
            params[f"layers.{i}.weight"] = w.to(device)
            params[f"layers.{i}.bias"] = torch.zeros(layer.out_features, dtype=dtype,
                                                     device=device)
        return params
