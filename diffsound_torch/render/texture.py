"""2D textures: bilinear sampling, mip chains and trilinear mip sampling.

Counterpart of `diffsound_tpu/render/texture.py`.  A `Texture2D` keeps its
trainable payload outside the object (an (H, W, C) tensor, or a list of
mips): `tex.params` is the initial value and `sample(params, uv, ...)`
reads whatever the caller holds, so the payload drops into an optimizer.
Sampling is bilinear within a mip and linear across mips, the level chosen
from the rasterizer's screen-space UV derivatives or an explicit bias;
average-pool downsampling is differentiable as written."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sample_bilinear(tex, uv, clamp: bool = True):
    """tex (H, W, C), uv (..., 2) in [0, 1] -> (..., C); texel indices
    clamped to the edge, or wrapped when `clamp` is False."""
    H, W, _ = tex.shape
    fu = uv[..., 0] * W - 0.5
    fv = uv[..., 1] * H - 0.5
    i0 = torch.floor(fu).long()
    j0 = torch.floor(fv).long()
    wu = (fu - i0)[..., None]
    wv = (fv - j0)[..., None]
    if clamp:
        i0c, i1c = torch.clamp(i0, 0, W - 1), torch.clamp(i0 + 1, 0, W - 1)
        j0c, j1c = torch.clamp(j0, 0, H - 1), torch.clamp(j0 + 1, 0, H - 1)
    else:
        i0c, i1c = torch.remainder(i0, W), torch.remainder(i0 + 1, W)
        j0c, j1c = torch.remainder(j0, H), torch.remainder(j0 + 1, H)
    c00, c01 = tex[j0c, i0c], tex[j0c, i1c]
    c10, c11 = tex[j1c, i0c], tex[j1c, i1c]
    return (1 - wv) * ((1 - wu) * c00 + wu * c01) + wv * ((1 - wu) * c10 + wu * c11)


def _to_hwc(init, device) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(init, np.float32), device=device)
    if a.dim() == 1:  # a constant colour
        return a[None, None, :]
    if a.dim() == 3:
        return a
    if a.dim() == 4:  # NHWC with N = 1
        return a[0]
    raise ValueError(f"invalid texture init shape {tuple(a.shape)}")


def mip_chain(tex, max_mips: Optional[int] = None):
    """(H, W, C) -> the list of mips down to 1 x 1 (2 x 2 average pooling,
    an odd edge's last row or column dropped)."""
    mips = [tex]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        if max_mips is not None and len(mips) >= max_mips:
            break
        h, w, c = mips[-1].shape
        m = mips[-1][: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2, c)
        mips.append(m.mean(dim=(1, 3)))
    return mips


class Texture2D:
    """A sampler over an (H, W, C) payload or a list of mips.

    init: a constant colour (C,), an image (H, W, C) or (1, H, W, C), or a
    custom mip list (then no mips are derived).  min_max: the [lo, hi]
    per-channel range `clamp` projects the payload into."""

    def __init__(self, init, min_max=None, auto_mips: bool = True, device="cpu"):
        if isinstance(init, (list, tuple)):
            self.params = [torch.as_tensor(np.asarray(m, np.float32), device=device)
                           for m in init]
            self.auto_mips = False
        else:
            self.params = _to_hwc(init, device)
            self.auto_mips = auto_mips
        self.min_max = min_max

    @staticmethod
    def mips_of(params, auto_mips: bool):
        if isinstance(params, (list, tuple)):
            return list(params)
        return mip_chain(params) if auto_mips else [params]

    def sample(self, params, uv, uv_deriv=None, mip_bias=None):
        """Trilinear sample at uv (..., 2).  uv_deriv (..., 4), the
        screen-space (du/dx, dv/dx, du/dy, dv/dy), selects the mip level;
        mip_bias (...) adds to it (or is the level without derivatives)."""
        mips = self.mips_of(params, self.auto_mips)
        n = len(mips)
        if n == 1:
            return sample_bilinear(mips[0], uv)
        H, W, _ = mips[0].shape
        if uv_deriv is not None:
            du = uv_deriv[..., 0::2] * W
            dv = uv_deriv[..., 1::2] * H
            rho = torch.sqrt(torch.clamp(torch.maximum((du * du).sum(-1), (dv * dv).sum(-1)),
                                         min=1e-20))
            level = torch.log2(torch.clamp(rho, min=1.0))
        else:
            level = torch.zeros(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
        if mip_bias is not None:
            level = level + mip_bias
        level = torch.clamp(level, 0.0, n - 1.0)
        lo = torch.clamp(torch.floor(level).long(), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        frac = (level - lo.to(level.dtype))[..., None]
        out_lo = out_hi = torch.zeros(uv.shape[:-1] + (mips[0].shape[-1],),
                                      dtype=mips[0].dtype, device=mips[0].device)
        for i, m in enumerate(mips):
            s = sample_bilinear(m, uv)
            out_lo = torch.where((lo == i)[..., None], s, out_lo)
            out_hi = torch.where((hi == i)[..., None], s, out_hi)
        return out_lo * (1 - frac) + out_hi * frac

    def clamp(self, params):
        """params projected into min_max (between optimizer steps)."""
        if self.min_max is None:
            return params

        def clip(m):
            lo = torch.as_tensor(self.min_max[0], dtype=m.dtype, device=m.device)
            hi = torch.as_tensor(self.min_max[1], dtype=m.dtype, device=m.device)
            return torch.minimum(torch.maximum(m, lo), hi)

        if isinstance(params, (list, tuple)):
            return [clip(m) for m in params]
        return clip(params)


def srgb_texture(img) -> np.ndarray:
    """An sRGB-encoded image as linear float32 (numpy)."""
    from .util import srgb_to_rgb

    return srgb_to_rgb(torch.as_tensor(np.asarray(img, np.float32))).numpy()
