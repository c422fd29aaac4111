"""Graphics math and image helpers of the render path.

Counterpart of `diffsound_tpu/render/util.py` (the part the joint and DLMesh
paths use): vector helpers, clip-space transforms, cubemap directions and
the face-local bilinear cubemap fetch, and PNG output with numpy and zlib
(`utils/visualize.py::write_png`) in place of imageio."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.visualize import write_png


def dot(x, y, keepdim: bool = True):
    s = (x * y).sum(dim=-1)
    return s[..., None] if keepdim else s


def reflect(x, n):
    return 2.0 * dot(x, n) * n - x


def length(x, eps: float = 1e-20):
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x, eps: float = 1e-20):
    return x / length(x, eps)


def xfm_points(points, mtx):
    """points (..., 3), mtx (4, 4) -> homogeneous clip coords (..., 4)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return p @ mtx.T


def _cube_to_dir_np(face: int, x, y):
    """Texel coords in [-1, 1] on `face` -> unnormalised direction, in the
    (+x, -x, +y, -y, +z, -z) cubemap layout."""
    o = np.ones_like(x)
    if face == 0:
        return np.stack([o, -y, -x], -1)
    if face == 1:
        return np.stack([-o, -y, x], -1)
    if face == 2:
        return np.stack([x, o, y], -1)
    if face == 3:
        return np.stack([x, -o, -y], -1)
    if face == 4:
        return np.stack([x, -y, o], -1)
    return np.stack([-x, -y, -o], -1)


def cubemap_directions(res: int):
    """-> dirs (6, res, res, 3) unit, solid angles (6, res, res), float32
    numpy."""
    g = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gy, gx = np.meshgrid(g, g, indexing="ij")
    # solid angle of a texel: 4 / (x^2+y^2+1)^(3/2) * (2/res)^2
    w = 4.0 / (gx**2 + gy**2 + 1.0) ** 1.5 * (2.0 / res) ** 2
    dirs = []
    for f in range(6):
        d = _cube_to_dir_np(f, gx, gy)
        dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.stack(dirs).astype(np.float32), np.stack([w] * 6).astype(np.float32)


def sample_cubemap(cubemap, dirs):
    """cubemap (6, R, R, C), dirs (..., 3) -> (..., C): the face of the
    dominant axis, bilinear within it with edge clamp (seam texels clamp
    instead of wrapping onto the neighbour face, as in the JAX package)."""
    R = cubemap.shape[1]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    face = torch.where(
        (ax >= ay) & (ax >= az),
        torch.where(x > 0, 0, 1),
        torch.where(ay >= az, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    )
    ma = torch.clamp(torch.maximum(torch.maximum(ax, ay), az), min=1e-20)
    xs, ys, zs = x / ma, y / ma, z / ma
    # face-local (u, v) in [-1, 1], the inverse of _cube_to_dir_np per face
    u = torch.stack([-zs, zs, xs, xs, xs, -xs], -1).gather(-1, face[..., None])[..., 0]
    v = torch.stack([-ys, -ys, zs, -zs, -ys, -ys], -1).gather(-1, face[..., None])[..., 0]

    fu = (u * 0.5 + 0.5) * R - 0.5
    fv = (v * 0.5 + 0.5) * R - 0.5
    i0 = torch.clamp(torch.floor(fu).long(), 0, R - 1)
    j0 = torch.clamp(torch.floor(fv).long(), 0, R - 1)
    i1 = torch.clamp(i0 + 1, 0, R - 1)
    j1 = torch.clamp(j0 + 1, 0, R - 1)
    wu = torch.clamp(fu - i0, 0.0, 1.0)[..., None]
    wv = torch.clamp(fv - j0, 0.0, 1.0)[..., None]
    c00, c01 = cubemap[face, j0, i0], cubemap[face, j0, i1]
    c10, c11 = cubemap[face, j1, i0], cubemap[face, j1, i1]
    return (1 - wv) * ((1 - wu) * c00 + wu * c01) + wv * ((1 - wu) * c10 + wu * c11)


def save_image(path: str, img):
    """(H, W, 3) or (H, W) float in [0, 1] -> 8-bit PNG; `.npy` keeps the
    float32 values."""
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img.astype(np.float32))
        return
    write_png(path, np.clip(img * 255.0, 0, 255).astype(np.uint8))
