"""Split-sum environment light with a trainable cubemap.

Counterpart of `diffsound_tpu/render/light.py`: the mip pyramid is
differentiable average pooling; diffuse irradiance and the GGX prefilters
are constant (N, N) linear operators on the pooled cubemap (one matmul each,
exact gradients); the Karis FG table comes from GGX importance-sampled
quadrature, vectorised over NdotV here and cached in the build directory
under a name of the port's own.

Params: {"base": (6, R, R, 3)} float32.  With one mip (base_res 16, the
joint config's) `_mip_roughness(0)` is 1.0 and `get_mip` offsets by
n_mips - 2 = -1, as in the JAX package."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .texture import sample_bilinear
from .util import cubemap_directions, dot, reflect, safe_normalize, sample_cubemap

FG_LUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


@functools.lru_cache(maxsize=8)
def _diffuse_operator(res: int) -> np.ndarray:
    """(N, N) cosine-lobe irradiance operator on the res cubemap, rows
    normalised so a constant radiance maps to itself."""
    dirs, dw = cubemap_directions(res)
    d, w = dirs.reshape(-1, 3), dw.reshape(-1)
    op = np.clip(d @ d.T, 0.0, None) * w[None, :] / np.pi
    op /= np.clip(op.sum(1, keepdims=True), 1e-9, None)
    return op.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _ggx_operator(res: int, roughness: float) -> np.ndarray:
    """(N, N) GGX-NDF-weighted prefilter operator at one roughness."""
    dirs, dw = cubemap_directions(res)
    d, w = dirs.reshape(-1, 3), dw.reshape(-1)
    a2 = max(roughness * roughness, 1e-4) ** 2
    cos = np.clip(d @ d.T, 0.0, 1.0)
    den = cos * cos * (a2 - 1.0) + 1.0
    op = a2 / (np.pi * den * den) * cos * w[None, :]
    op /= np.clip(op.sum(1, keepdims=True), 1e-9, None)
    return op.astype(np.float32)


def _hammersley(num_samples: int) -> np.ndarray:
    i = np.arange(num_samples)
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / num_samples, bits.astype(np.float64) * 2.3283064365386963e-10], -1)


def _fg_lut_compute(res: int, num_samples: int) -> np.ndarray:
    """Karis's split-sum FG term (Real Shading in Unreal Engine 4, 2013) over
    (NdotV, roughness), all NdotV of a roughness at once."""
    xi = _hammersley(num_samples)
    c = (np.arange(res) + 0.5) / res  # NdotV
    v = np.stack([np.sqrt(np.maximum(1 - c * c, 0.0)), np.zeros(res), c], -1)  # (res, 3)
    lut = np.zeros((res, res, 2), np.float64)
    for j, r in enumerate((np.arange(res) + 0.5) / res):
        a = max(r * r, 1e-4)
        # GGX importance sample of the half vector around +z
        phi = 2 * np.pi * xi[:, 0]
        ct = np.sqrt((1 - xi[:, 1]) / (1 + (a * a - 1) * xi[:, 1]))
        st = np.sqrt(np.clip(1 - ct * ct, 0, None))
        h = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)  # (S, 3)
        vh = v @ h.T  # (res, S)
        l_z = 2 * vh * h[None, :, 2] - v[:, 2:3]
        n_dot_l = np.clip(l_z, 0, None)
        n_dot_h = np.clip(h[:, 2], 1e-8, None)[None, :]
        v_dot_h = np.clip(vh, 1e-8, None)
        # height-correlated Smith visibility, k = alpha / 2
        k_vis = a / 2.0
        g_v = (c / (c * (1 - k_vis) + k_vis))[:, None]
        g_l = n_dot_l / (n_dot_l * (1 - k_vis) + k_vis)
        g_vis = g_v * g_l * v_dot_h / (n_dot_h * np.maximum(c, 1e-8)[:, None])
        fc = (1 - v_dot_h) ** 5
        mask = n_dot_l > 0
        lut[:, j, 0] = np.where(mask, (1 - fc) * g_vis, 0).sum(1) / num_samples
        lut[:, j, 1] = np.where(mask, fc * g_vis, 0).sum(1) / num_samples
    return lut.astype(np.float32)


@functools.lru_cache(maxsize=1)
def fg_lut(res: int = 256, num_samples: int = 1024) -> np.ndarray:
    """(res, res, 2) float32 FG table over (NdotV, roughness), cached as
    build/fg_lut_<res>_<samples>.npy."""
    path = os.path.join(FG_LUT_DIR, f"fg_lut_{res}_{num_samples}.npy")
    if os.path.exists(path):
        lut = np.load(path)
        if lut.shape == (res, res, 2):
            return lut
    lut = _fg_lut_compute(res, num_samples)
    try:
        os.makedirs(FG_LUT_DIR, exist_ok=True)
        np.save(path + ".part.npy", lut)
        os.replace(path + ".part.npy", path)
    except OSError:
        pass
    return lut


@functools.lru_cache(maxsize=64)
def _on_device(key, device: torch.device) -> torch.Tensor:
    """A constant table (named by its kind and arguments) as a float32 tensor on
    `device`."""
    kind, args = key
    table = {"diffuse": _diffuse_operator, "ggx": _ggx_operator, "fg": fg_lut}[kind](*args)
    return torch.as_tensor(table, device=device)


def _avg_pool_cube(c):
    f, h, w, ch = c.shape
    return c.reshape(f, h // 2, 2, w // 2, 2, ch).mean(dim=(2, 4))


class EnvironmentLight:
    LIGHT_MIN_RES = 16
    MIN_ROUGHNESS = 0.08
    MAX_ROUGHNESS = 0.5

    def __init__(self, base_res: int = 64, filter_res: int = 32):
        self.base_res = base_res
        self.filter_res = min(filter_res, base_res)
        self.mip_res = [base_res]
        while self.mip_res[-1] > self.LIGHT_MIN_RES:
            self.mip_res.append(self.mip_res[-1] // 2)
        self.n_mips = len(self.mip_res)

    def init_params(self, generator: torch.Generator, scale: float = 0.5, bias: float = 0.25,
                    device="cpu"):
        """A random trainable env map, uniform in [bias, bias + scale),
        drawn from `generator` (a CPU generator; the values move to
        `device`)."""
        u = torch.rand((6, self.base_res, self.base_res, 3), generator=generator)
        return {"base": (u * scale + bias).to(device)}

    def _mip_roughness(self, i: int) -> float:
        if i == self.n_mips - 1:
            return 1.0
        return (i / max(self.n_mips - 2, 1)) * (
            self.MAX_ROUGHNESS - self.MIN_ROUGHNESS) + self.MIN_ROUGHNESS

    def build_mips(self, params):
        """-> (diffuse cube at the coarsest mip, specular mip list)."""
        mips = [params["base"]]
        for _ in range(self.n_mips - 1):
            mips.append(_avg_pool_cube(mips[-1]))
        dev = mips[0].device

        def apply_op(key, cube):
            f, r, _, ch = cube.shape
            op = _on_device(key, dev).to(cube.dtype)
            return (op @ cube.reshape(-1, ch)).reshape(f, r, r, ch)

        diffuse = apply_op(("diffuse", (self.mip_res[-1],)), mips[-1])
        specular = []
        for i, m in enumerate(mips):
            r = self.mip_res[i]
            if r <= self.filter_res:
                specular.append(apply_op(("ggx", (r, self._mip_roughness(i))), m))
            else:
                specular.append(m)
        return diffuse, specular

    def get_mip(self, roughness):
        """Roughness -> fractional mip level."""
        n = self.n_mips
        lo, hi = self.MIN_ROUGHNESS, self.MAX_ROUGHNESS
        return torch.where(
            roughness < hi,
            (torch.clamp(roughness, lo, hi) - lo) / (hi - lo) * (n - 2),
            (torch.clamp(roughness, hi, 1.0) - hi) / (1.0 - hi) + n - 2,
        )

    def regularizer(self, params):
        """White-balance regularizer."""
        base = params["base"]
        return (base - base.mean(dim=-1, keepdim=True)).abs().mean()

    def shade(self, params, gb_pos, gb_normal, kd, ks, view_pos, specular: bool = True):
        """Image-space deferred shade; inputs (..., C), view_pos
        broadcastable to gb_pos."""
        wo = safe_normalize(view_pos - gb_pos)
        diffuse_cube, spec_mips = self.build_mips(params)
        if specular:
            roughness = ks[..., 1:2]
            metallic = ks[..., 2:3]
            spec_col = (1.0 - metallic) * 0.04 + kd * metallic
            diff_col = kd * (1.0 - metallic)
        else:
            diff_col = kd
        reflvec = safe_normalize(reflect(wo, gb_normal))
        shaded = sample_cubemap(diffuse_cube, gb_normal) * diff_col

        if specular:
            n_dot_v = torch.clamp(dot(wo, gb_normal), min=1e-4)
            fg = sample_bilinear(_on_device(("fg", ()), gb_pos.device),
                                 torch.cat([n_dot_v, roughness], dim=-1))
            miplevel = self.get_mip(roughness)[..., 0]
            lo = torch.clamp(torch.floor(miplevel).long(), 0, self.n_mips - 1)
            frac = (miplevel - lo.to(miplevel.dtype))[..., None]
            hi = torch.clamp(lo + 1, 0, self.n_mips - 1)
            spec_lo = torch.zeros_like(shaded)
            spec_hi = torch.zeros_like(shaded)
            for i, m in enumerate(spec_mips):
                s = sample_cubemap(m, reflvec)
                spec_lo = torch.where((lo == i)[..., None], s, spec_lo)
                spec_hi = torch.where((hi == i)[..., None], s, spec_hi)
            spec = spec_lo * (1 - frac) + spec_hi * frac
            shaded = shaded + spec * (spec_col * fg[..., 0:1] + fg[..., 1:2])
        return shaded * (1.0 - ks[..., 0:1])  # occlusion
