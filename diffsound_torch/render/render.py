"""Deferred PBR render: rasterize -> interpolate -> shade -> composite.

Counterpart of `diffsound_tpu/render/render.py` (`shade`, `render_layer`,
`render_mesh`): the rasterizer is the chunked sweep of `rasterize.py` (layer
peeling re-runs it behind a depth floor) and silhouette gradients come from
its straight-through soft coverage.  Materials and lights are (module,
params) pairs, so the render is a function of its parameter tensors.

The albedo-smoothness jitter, a standard normal draw the JAX package takes
from a PRNG key, comes from a `torch.Generator` on the inputs' device, or is
passed in as the tensor `noise` itself."""

from __future__ import annotations

from typing import Optional

import torch

from .bsdf import prepare_shading_normal
from .light import EnvironmentLight
from .mesh import Mesh, face_normals
from .rasterize import Rast, interpolate, interpolate_face, rasterize
from .util import xfm_points


def _draw(like, generator, noise):
    """The jitter's standard normal draw shaped like `like`: `noise` when
    given, else from `generator`, else None (no jitter)."""
    if noise is not None:
        return noise.to(like)
    if generator is not None:
        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    return None


def shade(gb_pos, gb_geometric_normal, gb_normal, gb_tangent, gb_texc, view_pos,
          light: EnvironmentLight, light_params, material: dict, mat_params: dict,
          bsdf: Optional[str] = None, generator: Optional[torch.Generator] = None,
          noise: Optional[torch.Tensor] = None):
    """Pixel shader on interpolated G-buffers.  Returns {'shaded', 'kd_grad',
    'occlusion'}, each (..., C + 1) with the material's alpha last.
    `noise` (shaped like gb_pos for an MLP texture, like gb_texc otherwise)
    or `generator` turns on the kd-gradient jitter."""
    perturbed_nrm = None
    if "kd_ks_normal" in material:
        mlp = material["kd_ks_normal"]
        p = mat_params["kd_ks_normal"]
        all_tex = mlp.sample(p, gb_pos)
        n = _draw(gb_pos, generator, noise)
        if n is not None:
            all_tex_jitter = mlp.sample(p, gb_pos + 0.01 * n)
            kd_grad = (all_tex_jitter[..., :-6] - all_tex[..., :-6]).abs().sum(-1, keepdim=True) / 3
        else:
            kd_grad = torch.zeros_like(all_tex[..., :1])
        kd, ks, perturbed_nrm = all_tex[..., :-6], all_tex[..., -6:-3], all_tex[..., -3:]
    else:
        kd = material["kd"].sample(mat_params["kd"], gb_texc)
        ks = material["ks"].sample(mat_params["ks"], gb_texc)[..., 0:3]
        if "normal" in material:
            perturbed_nrm = material["normal"].sample(mat_params["normal"], gb_texc)
        n = _draw(gb_texc, generator, noise)
        if n is not None:
            kd_jitter = material["kd"].sample(mat_params["kd"], gb_texc + 0.005 * n)
            kd_grad = (kd_jitter[..., 0:3] - kd[..., 0:3]).abs().sum(-1, keepdim=True) / 3
        else:
            kd_grad = torch.zeros_like(kd[..., :1])

    alpha = kd[..., 3:4] if kd.shape[-1] == 4 else torch.ones_like(kd[..., 0:1])
    kd = kd[..., 0:3]
    if material.get("no_perturbed_nrm", False):
        perturbed_nrm = None
    gb_normal = prepare_shading_normal(gb_pos, view_pos, perturbed_nrm, gb_normal, gb_tangent,
                                       gb_geometric_normal, two_sided_shading=True, opengl=True)

    bsdf_name = bsdf if bsdf is not None else material.get("bsdf", "pbr")
    if bsdf_name in ("pbr", "diffuse"):
        shaded_col = light.shade(light_params, gb_pos, gb_normal, kd, ks, view_pos,
                                 specular=bsdf_name == "pbr")
    elif bsdf_name == "normal":
        shaded_col = (gb_normal + 1.0) * 0.5
    elif bsdf_name == "tangent":
        shaded_col = (gb_tangent + 1.0) * 0.5
    elif bsdf_name == "kd":
        shaded_col = kd
    elif bsdf_name == "ks":
        shaded_col = ks
    else:
        raise ValueError(f"invalid bsdf '{bsdf_name}'")
    return {
        "shaded": torch.cat([shaded_col, alpha], -1),
        "kd_grad": torch.cat([kd_grad, alpha], -1),
        "occlusion": torch.cat([ks[..., :1], alpha], -1),
    }


def render_layer(rast: Rast, mesh: Mesh, mat_params: dict, light: EnvironmentLight,
                 light_params, view_pos, bsdf: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
    """Interpolate one depth layer's G-buffers and shade it."""
    tris = mesh.t_pos_idx
    gb_pos = interpolate(mesh.v_pos, rast, tris)
    gb_geom_nrm = interpolate_face(face_normals(mesh.v_pos, tris), rast)
    gb_normal = interpolate(mesh.v_nrm, rast, mesh.t_nrm_idx)
    if mesh.v_tng is not None:
        gb_tangent = interpolate(mesh.v_tng, rast, mesh.t_tng_idx)
    else:
        gb_tangent = gb_pos.new_tensor([1.0, 0.0, 0.0]).expand(gb_pos.shape)
    if mesh.v_tex is not None:
        gb_texc = interpolate(mesh.v_tex, rast, mesh.t_tex_idx)
    else:
        gb_texc = gb_pos[..., :2]
    return shade(gb_pos, gb_geom_nrm, gb_normal, gb_tangent, gb_texc, view_pos, light,
                 light_params, mesh.material, mat_params, bsdf, generator)


def render_mesh(mesh: Mesh, mat_params: dict, light: EnvironmentLight, light_params, mvp,
                view_pos, resolution: tuple, num_layers: int = 1, background=None,
                bsdf: Optional[str] = None, tri_mask=None,
                generator: Optional[torch.Generator] = None, soft_sigma: float = 1.0,
                spp: int = 1):
    """Depth-peeled render composited over a background.  Returns
    {'shaded', 'kd_grad', 'occlusion'} as (H, W, 4) buffers.

    spp > 1 supersamples: rasterize and shade at (H spp, W spp), then
    box-filter down."""
    H, W = resolution
    if spp > 1:
        bg = None if background is None else background.repeat_interleave(
            spp, 0).repeat_interleave(spp, 1)
        hi = render_mesh(mesh, mat_params, light, light_params, mvp, view_pos, (H * spp, W * spp),
                         num_layers=num_layers, background=bg, bsdf=bsdf, tri_mask=tri_mask,
                         generator=generator, soft_sigma=soft_sigma * spp, spp=1)
        return {k: v.reshape(H, spp, W, spp, v.shape[-1]).mean(dim=(1, 3)) for k, v in hi.items()}
    dev = mesh.v_pos.device
    v_clip = xfm_points(mesh.v_pos, torch.as_tensor(mvp, dtype=mesh.v_pos.dtype, device=dev))
    view_pos = torch.as_tensor(view_pos, dtype=torch.float32, device=dev).reshape(1, 1, 3)
    rasts = rasterize(v_clip, mesh.t_pos_idx, resolution, tri_mask=tri_mask,
                      num_layers=num_layers, soft_sigma=soft_sigma)
    layers = [(render_layer(r, mesh, mat_params, light, light_params, view_pos, bsdf, generator), r)
              for r in rasts]

    if background is None:
        background = torch.zeros((H, W, 4), device=dev)
    elif background.shape[-1] == 3:
        background = torch.cat([background, torch.zeros_like(background[..., :1])], -1)
    out = {}
    for key in layers[0][0]:
        accum = background if key == "shaded" else torch.zeros_like(layers[0][0][key])
        for buffers, r in reversed(layers):
            # the rasterizer's straight-through coverage carries silhouette
            # gradients to the vertex positions
            alpha = r.alpha_soft[..., None] * buffers[key][..., -1:]
            rgb = torch.cat([buffers[key][..., :-1], torch.ones_like(buffers[key][..., -1:])], -1)
            accum = accum + alpha * (rgb - accum)
        out[key] = accum
    return out
