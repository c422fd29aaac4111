"""Neural SDF with positional encoding and a per-vertex deformation.

Counterpart of `diffsound_tpu/geometry/sdf_mlp.py`: sin/cos positional
encoding with frequencies 2^i, a ReLU MLP (hidden 512, `layer_num` + 1
hidden layers), a trainable per-vertex `deform` bounded through tanh, and
the voxel-constraint hinge `mesh_template_loss`.

The parameters are explicit, as flax's are: a dict
{"mlp": {"layers.i.weight", "layers.i.bias"}, "deform": (V, 3)} applied
through `torch.func.functional_call` (`SDFNet.evaluate`).  `SDFNet`'s own
layers are built on the meta device and hold no values; `SDFNet.init_params` draws flax's
initialisation (truncated lecun-normal kernels, zero biases) from an
explicit `torch.Generator`.  Layer i is flax's `Dense_i`, its weight the
transposed kernel (`convert.sdf_params_from_jax`).

The parameters' dtype is the computation's: float64 on the CPU, float32 on
the card; `cast_params` moves a parameter dict to another dtype (the
detached march runs in float64 on every device).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import default_dtype, resolve_device

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# a normal truncated to +-2 standard deviations, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class PositionalEncoding(nn.Module):
    def __init__(self, freq_num: int = 1, scale: float = 1.0):
        super().__init__()
        self.freq_num = freq_num
        self.scale = scale

    def forward(self, x):
        feats = [x]
        for i in range(self.freq_num):
            f = 2.0**i
            feats.append(torch.sin(f * math.pi * x / self.scale))
            feats.append(torch.cos(f * math.pi * x / self.scale))
        return torch.cat(feats, dim=-1)


class SDFNet(nn.Module):
    """x (..., 3) -> sdf (...): encoding, `layer_num` + 1 ReLU layers of
    width `hidden_dim`, a linear output (flax's Dense_0 .. Dense_{layer_num+1})."""

    def __init__(self, freq_num: int = 1, scale: float = 1.0, layer_num: int = 3,
                 hidden_dim: int = 512):
        super().__init__()
        self.encoding = PositionalEncoding(freq_num, scale)
        dims = [3 * (1 + 2 * freq_num)] + [hidden_dim] * (layer_num + 1) + [1]
        # structure only: the values are the explicit parameter dicts
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device="meta") for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x):
        x = self.encoding(x)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]

    def evaluate(self, params: dict, x):
        """The network with the parameter dict `params` (flax's apply)."""
        return torch.func.functional_call(self, params, (x,))

    def init_params(self, generator: torch.Generator, dtype=torch.float64, device="cpu") -> dict:
        """flax's Dense initialisation, drawn from `generator` (a CPU
        generator; the values move to `device`)."""
        lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
        params = {}
        for i, layer in enumerate(self.layers):
            fan_in = layer.in_features
            u = torch.rand((fan_in, layer.out_features), generator=generator, dtype=torch.float64)
            z = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
            kernel = z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            params[f"layers.{i}.weight"] = kernel.T.to(dtype=dtype, device=device).contiguous()
            params[f"layers.{i}.bias"] = torch.zeros(layer.out_features, dtype=dtype,
                                                     device=device)
        return params


def cast_params(params, dtype):
    """A (nested) parameter dict with every tensor cast to `dtype`."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


class SDFGeometry:
    """SDF-MLP + deform geometry over a background grid on `device`."""

    def __init__(self, grid_verts: np.ndarray, grid_res: int, scale: float = 1.0,
                 freq_num: int = 1, hidden_dim: int = 512, layer_num: int = 3,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device)
        self.verts = torch.as_tensor(np.asarray(grid_verts, np.float64), device=self.device)
        self.grid_res = grid_res
        self.scale = scale
        self.net = SDFNet(freq_num, scale, layer_num, hidden_dim)
        self.deform_bound = scale * 1.8 / (grid_res * 2)

    def init_params(self, generator: torch.Generator) -> dict:
        return {
            "mlp": self.net.init_params(generator, self.dtype, self.device),
            "deform": torch.zeros(self.verts.shape, dtype=self.dtype, device=self.device),
        }

    def deformed_verts(self, params):
        deform = params["deform"]
        return self.verts.to(deform.dtype) + self.deform_bound * torch.tanh(deform)

    def sdf(self, params):
        return self.net.evaluate(params["mlp"], self.deformed_verts(params) / self.scale)

    def sdf_at(self, params, points):
        return self.net.evaluate(params["mlp"], points)

    def pretrain_regression(self, params, points, sdf_vals, **kw):
        """Direct SDF regression of the MLP (see train_sdf_regression)."""
        params = dict(params)
        pts = torch.as_tensor(np.asarray(points) / self.scale, dtype=self.dtype,
                              device=self.device)
        params["mlp"] = train_sdf_regression(self.net, params["mlp"], pts, sdf_vals, **kw)
        return params

    def mesh_template_loss(self, params, query_points, signed_distance, margin: float = 0.0):
        """Hinge on sign agreement with a coarse voxel constraint: inside
        points (sd > margin) whose predicted sdf <= margin contribute -sdf;
        outside points (sd < -margin) whose predicted sdf >= margin
        contribute +sdf."""
        pred = self.sdf_at(params, query_points)
        inside = signed_distance > margin
        outside = signed_distance < -margin
        zero = pred.new_zeros(())
        pen_in = torch.where(inside & (pred <= margin), -pred, zero)
        pen_out = torch.where(outside & (pred >= margin), pred, zero)
        return (pen_in.sum() + pen_out.sum()) / self.grid_res**3 * 1000.0


def regression_loss(net: SDFNet, params: dict, points, sdf_vals):
    """Mean squared error of the SDF on sampled points."""
    return ((net.evaluate(params, points) - sdf_vals) ** 2).mean()


def train_sdf_regression(net: SDFNet, params: dict, points, sdf_vals, iters: int = 1000,
                         lr: float = 1e-4, batch: int = 8192, seed: int = 0) -> dict:
    """Direct SDF-regression pretraining of one MLP: Adam on the mean
    squared error of batches drawn with replacement (the JAX package draws
    them from `jax.random`, the port from a `torch.Generator` seeded
    `seed`).  Returns the updated parameter dict."""
    dev = next(iter(params.values())).device
    pts = torch.as_tensor(points, device=dev)
    sd = torch.as_tensor(np.asarray(sdf_vals), dtype=pts.dtype, device=dev)
    n = pts.shape[0]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(iters):
        idx = torch.randint(0, n, (min(batch, n),), generator=gen).to(dev)
        opt.zero_grad(set_to_none=True)
        regression_loss(net, p, pts[idx], sd[idx]).backward()
        opt.step()
    return {k: v.detach() for k, v in p.items()}


def voxelize_occupancy(signed_distance: np.ndarray, voxel_num: int):
    """Occupied-voxel integer coords from an inside-positive SDF sampled on
    a voxel_num^3 lattice in [-0.5, 0.5]^3."""
    occ = np.asarray(signed_distance).reshape(voxel_num, voxel_num, voxel_num) > 0
    return np.argwhere(occ)


def voxel_boundary_faces(coords: np.ndarray, resolution: int):
    """Boundary quad faces (as triangles) of an occupied voxel set, keeping
    only faces adjacent to the outside connected region (interior cavities
    excluded).  Numpy/scipy copy of the JAX package's, in its face order.

    Returns (verts (V, 3) float lattice coords, tris (F, 3) int)."""
    from scipy import ndimage

    res = resolution + 2
    occ = np.zeros((res, res, res), bool)
    occ[tuple((coords + 1).T)] = True
    free = ~occ
    outside = np.zeros_like(free)
    outside[0, 0, 0] = True
    outside = ndimage.binary_propagation(outside, mask=free)

    dirs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])
    # local quad corner offsets for the face in each direction
    face_corners = {
        (1, 0, 0): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
        (-1, 0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
        (0, 1, 0): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
        (0, -1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
        (0, 0, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
        (0, 0, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
    }
    vid = {}
    verts = []
    tris = []
    cells = coords + 1
    for d in dirs:
        exposed = outside[tuple((cells + d).T)]
        for c in cells[exposed]:
            quad = []
            for off in face_corners[tuple(d)]:
                v = tuple(c + np.asarray(off))
                if v not in vid:
                    vid[v] = len(verts)
                    verts.append(np.asarray(v) - 1)
                quad.append(vid[v])
            tris.append([quad[0], quad[1], quad[2]])
            tris.append([quad[0], quad[2], quad[3]])
    return np.asarray(verts, np.float64), np.asarray(tris, np.int64)
