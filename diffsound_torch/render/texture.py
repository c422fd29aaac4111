"""Bilinear texture sampling.

Counterpart of `diffsound_tpu/render/texture.py::sample_bilinear` (the
environment light's FG lookup and the jittered image gradient use it)."""

from __future__ import annotations

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
