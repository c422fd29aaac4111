"""Graphics math and image helpers of the render path.

Counterpart of `diffsound_tpu/render/util.py`: vector helpers, the sRGB
transfer and tonemap, camera matrices (numpy, OpenGL conventions), image
pooling and resizing, cubemap directions, the face-local bilinear cubemap
fetch and the latlong conversions, and image IO with numpy and zlib in
place of imageio: `save_image` writes 8-bit PNG (`utils/visualize.py::
write_png`) or `.npy`, `load_image` reads them back (PNG: 8 bits, colour
types gray, RGB, gray + alpha and RGBA, filters 0-4, not interlaced)."""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

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


def srgb_to_rgb(f):
    return torch.where(f <= 0.04045, f / 12.92,
                       ((torch.clamp(f, min=0.04045) + 0.055) / 1.055) ** 2.4)


def rgb_to_srgb(f):
    return torch.where(f <= 0.0031308, f * 12.92,
                       1.055 * torch.clamp(f, min=0.0031308) ** (1.0 / 2.4) - 0.055)


def tonemap_srgb(f):
    """Clamp to [0, 1], then the sRGB transfer."""
    return rgb_to_srgb(torch.clamp(f, 0.0, 1.0))


# -- camera matrices (numpy float32, OpenGL conventions) ---------------------


def perspective(fovy: float = 0.7854, aspect: float = 1.0, n: float = 0.1, f: float = 1000.0):
    y = np.tan(fovy / 2)
    return np.array([[1 / (y * aspect), 0, 0, 0],
                     [0, 1 / -y, 0, 0],
                     [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
                     [0, 0, -1, 0]], dtype=np.float32)


def translate(x: float, y: float, z: float):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def rotate_x(a: float):
    s, c = np.sin(a), np.cos(a)
    return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], dtype=np.float32)


def rotate_y(a: float):
    s, c = np.sin(a), np.cos(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32)


def lookat(eye, at, up):
    eye, at, up = (np.asarray(v, np.float32) for v in (eye, at, up))
    f = at - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def random_camera(rng: np.random.Generator, radius: float = 3.0, fovy: float = 0.7854):
    """A random orbit camera looking at the origin from a uniform direction:
    (mvp (4, 4), campos (3,)), float32 numpy."""
    v = rng.normal(size=3)
    v /= np.linalg.norm(v)
    eye = v * radius
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(v, up)) > 0.98:
        up = np.array([1.0, 0.0, 0.0])
    mvp = perspective(fovy) @ lookat(eye, np.zeros(3), up)
    return mvp.astype(np.float32), eye.astype(np.float32)


def xfm_points(points, mtx):
    """points (..., 3), mtx (4, 4) -> homogeneous clip coords (..., 4)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return p @ mtx.T


def xfm_vectors(vectors, mtx):
    """Direction vectors (..., 3) rotated by the upper 3x3 of mtx."""
    return vectors @ mtx[:3, :3].T


# -- image scaling -------------------------------------------------------------


def avg_pool_nhwc(x, size: int):
    """(N, H, W, C) average pool by an integer factor."""
    if size == 1:
        return x
    n, h, w, c = x.shape
    return x.reshape(n, h // size, size, w // size, size, c).mean(dim=(2, 4))


def scale_img_nhwc(x, size, method: str = "nearest"):
    """(N, H, W, C) resized to size = (H', W'), as `jax.image.resize`
    resizes: "nearest" at half-pixel centres, "bilinear" (or "linear")
    with the triangle kernel widened when it shrinks (antialiased)."""
    y = x.permute(0, 3, 1, 2)
    if method == "nearest":
        y = F.interpolate(y, size=tuple(size), mode="nearest-exact")
    elif method in ("bilinear", "linear"):
        shrink = size[0] < x.shape[1] or size[1] < x.shape[2]
        y = F.interpolate(y, size=tuple(size), mode="bilinear", align_corners=False,
                          antialias=shrink)
    else:
        raise ValueError(f"scale_img_nhwc: unknown method {method!r}")
    return y.permute(0, 2, 3, 1)


def cube_to_dir(face: int, x, y):
    """Texel coords (tensors) in [-1, 1] on `face` -> unnormalised
    direction, in the (+x, -x, +y, -y, +z, -z) cubemap layout."""
    o = torch.ones_like(x)
    return torch.stack([(o, -y, -x), (-o, -y, x), (x, o, y), (x, -o, -y), (x, -y, o),
                        (-x, -y, -o)][face], -1)


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


def latlong_to_cubemap(latlong, res: int):
    """(H, W, C) equirectangular map -> (6, res, res, C), bilinear (wrapping
    in longitude, clamped at the poles)."""
    dirs, _ = cubemap_directions(res)
    d = torch.as_tensor(dirs.reshape(-1, 3), device=latlong.device)
    H, W, C = latlong.shape
    theta = torch.arccos(torch.clamp(d[:, 1], -1, 1))
    phi = torch.atan2(d[:, 0], -d[:, 2])
    fu = (phi / (2 * math.pi) + 0.5) * W - 0.5
    fv = theta / math.pi * H - 0.5
    i0 = torch.remainder(torch.floor(fu).long(), W)
    i1 = torch.remainder(i0 + 1, W)
    j0 = torch.clamp(torch.floor(fv).long(), 0, H - 1)
    j1 = torch.clamp(j0 + 1, 0, H - 1)
    wu = (fu - torch.floor(fu))[:, None].to(latlong.dtype)
    wv = torch.clamp(fv - j0, 0.0, 1.0)[:, None].to(latlong.dtype)
    out = (1 - wv) * ((1 - wu) * latlong[j0, i0] + wu * latlong[j0, i1]) + wv * (
        (1 - wu) * latlong[j1, i0] + wu * latlong[j1, i1])
    return out.reshape(6, res, res, C)


def cubemap_to_latlong(cubemap, size):
    """(6, R, R, C) cubemap -> (H, W, C) equirectangular map."""
    H, W = size
    theta = (np.arange(H) + 0.5) / H * math.pi
    phi = ((np.arange(W) + 0.5) / W - 0.5) * 2 * math.pi
    st, ct = np.sin(theta), np.cos(theta)
    d = np.stack(np.broadcast_arrays(np.sin(phi)[None, :] * st[:, None],
                                     np.broadcast_to(ct[:, None], (H, W)),
                                     -np.cos(phi)[None, :] * st[:, None]), axis=-1)
    return sample_cubemap(cubemap, torch.as_tensor(d, dtype=torch.float32,
                                                   device=cubemap.device))


def save_image(path: str, img):
    """(H, W, 3) or (H, W) float in [0, 1] -> 8-bit PNG; `.npy` keeps the
    float32 values."""
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img.astype(np.float32))
        return
    write_png(path, np.clip(img * 255.0, 0, 255).astype(np.uint8))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of 8-bit samples, bpp bytes a pixel."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        kind, line = rows[r, 0], rows[r, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = (np.cumsum(line.reshape(w, bpp), axis=0) & 0xFF).reshape(-1)
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter {kind} unknown")
        out[r] = prev = cur
    return out.astype(np.uint8)


def _read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}; this reader takes 8-bit gray, gray + alpha, RGB or "
                         f"RGBA, not interlaced")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels).reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def load_image(path: str) -> np.ndarray:
    """An image `save_image` wrote (or any 8-bit PNG of the kinds
    `_read_png` takes) as float32: PNG values over 255, `.npy` as stored."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return _read_png(path).astype(np.float32) / 255.0
