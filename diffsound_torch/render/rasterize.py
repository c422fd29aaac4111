"""Differentiable rasterization in plain PyTorch.

Counterpart of `diffsound_tpu/render/rasterize.py` (an XLA operator there,
not a Pallas kernel), which replaces nvdiffrast:

  * hard visibility is a chunked z-buffer sweep: each chunk of triangles
    evaluates its edge functions against every pixel as dense (chunk, H, W)
    arrays, and the running per-pixel (depth, id) minimum is carried over
    the chunks.  The sweep runs without autograd: ids are detached, as in
    any z-buffer.  Capacity-padded triangle buffers come with a mask;
  * the winning triangle's barycentrics are recomputed analytically from
    the clip-space vertices (`_resolve_bary`), so gradients reach vertex
    positions through the interpolated attributes;
  * silhouette gradients come from a soft-coverage channel, the per-pixel
    max over triangles of a sigmoid of the signed pixel distance to each
    triangle, taken straight-through on the hard 0/1 coverage.  Autograd
    keeps nothing of a chunk: `_Chunk` saves the chunk's corners and
    recomputes its soft channel in the backward;
  * depth peeling re-runs the sweep behind the previous layer's depth.

Ties follow the JAX package: the z argmin takes the first index; the max
over a chunk (`torch.amax`) splits a tied gradient evenly, and the running
`torch.maximum` halves it at a tie.

Conventions (nvdiffrast's): clip-space input (V, 4), `tri_id` 1-based with
0 = empty, perspective-correct (u, v) with w = 1 - u - v on vertex order
(0, 1, 2).  The rasterizer computes in float32 whatever its input's dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Rast(NamedTuple):
    u: torch.Tensor  # (H, W) perspective-correct barycentric of vertex 1
    v: torch.Tensor  # (H, W) of vertex 2
    zw: torch.Tensor  # (H, W) NDC depth of the hit (inf where empty)
    tri_id: torch.Tensor  # (H, W) int64, 1-based, 0 = no hit
    alpha_soft: torch.Tensor  # (H, W) coverage: hard value, soft gradient


def default_chunk(H: int, W: int) -> int:
    """Triangles per sweep chunk: about 4M (triangle, pixel) pairs."""
    return max(8, min(256, (1 << 22) // max(H * W, 1)))


def _pixel_grid(H: int, W: int, device, dtype=torch.float32):
    """Pixel-centre NDC coords (each (H, W)); row 0 maps to y = -1."""
    px = (torch.arange(W, dtype=dtype, device=device) + 0.5) / W * 2.0 - 1.0
    py = (torch.arange(H, dtype=dtype, device=device) + 0.5) / H * 2.0 - 1.0
    return torch.meshgrid(px, py, indexing="xy")


def _tri_setup(a, b, c):
    """Per-triangle screen-space quantities from the corners' clip coords
    a, b, c (T, 4)."""
    w_a, w_b, w_c = a[:, 3], b[:, 3], c[:, 3]
    eps = 1e-9
    valid_w = (w_a > eps) & (w_b > eps) & (w_c > eps)

    def inv(w):
        return 1.0 / torch.where(w.abs() < eps, torch.full_like(w, eps), w)

    pa = a[:, :2] * inv(w_a)[:, None]
    pb = b[:, :2] * inv(w_b)[:, None]
    pc = c[:, :2] * inv(w_c)[:, None]
    za, zb, zc = a[:, 2] * inv(w_a), b[:, 2] * inv(w_b), c[:, 2] * inv(w_c)
    area = ((pb[:, 0] - pa[:, 0]) * (pc[:, 1] - pa[:, 1])
            - (pb[:, 1] - pa[:, 1]) * (pc[:, 0] - pa[:, 0]))
    return pa, pb, pc, za, zb, zc, area, valid_w


def _edge(p0, p1, px, py):
    """Edge function (p1 - p0) x (pixel - p0): (T, 2) against (H, W) ->
    (T, H, W)."""
    ex = (p1[:, 0] - p0[:, 0])[:, None, None]
    ey = (p1[:, 1] - p0[:, 1])[:, None, None]
    return ex * (py[None] - p0[:, 1][:, None, None]) - ey * (px[None] - p0[:, 0][:, None, None])


def _edges(corners, cmask, px, py):
    """The chunk's oriented edge functions e0, e1, e2 (T, H, W), its setup
    and its validity `ok` (T, 1, 1)."""
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    pa, pb, pc, za, zb, zc, area, valid_w = _tri_setup(a, b, c)
    s = torch.sign(area)
    s = torch.where(s == 0, torch.ones_like(s), s)[:, None, None]
    e0 = _edge(pb, pc, px, py) * s  # opposite vertex a
    e1 = _edge(pc, pa, px, py) * s
    e2 = _edge(pa, pb, px, py) * s
    ok = (valid_w & cmask & (area.abs() > 1e-12))[:, None, None]
    return (e0, e1, e2), (pa, pb, pc, za, zb, zc, area), ok


def _soft(edges, setup, ok, H: int, W: int, sigma: float):
    """Max over the chunk's triangles of the sigmoid of the signed pixel
    distance to each triangle's boundary: (H, W)."""
    e0, e1, e2 = edges
    pa, pb, pc = setup[:3]

    def elen(p0, p1):
        # clamp INSIDE the sqrt: padded (zero-area) triangles have exact-zero
        # edge vectors, and sqrt'(0) = inf would leak NaN through the mask
        l2 = ((p1[:, 0] - p0[:, 0]) * (0.5 * W)) ** 2 + ((p1[:, 1] - p0[:, 1]) * (0.5 * H)) ** 2
        return torch.sqrt(torch.clamp(l2, min=1e-24))

    # edge functions are in NDC^2 units; convert to pixel distance
    d0 = e0 * (0.25 * W * H) / elen(pb, pc)[:, None, None]
    d1 = e1 * (0.25 * W * H) / elen(pc, pa)[:, None, None]
    d2 = e2 * (0.25 * W * H) / elen(pa, pb)[:, None, None]
    d = torch.minimum(torch.minimum(d0, d1), d2)
    soft = torch.where(ok, torch.sigmoid(d / sigma), torch.zeros_like(d))
    # union by max (not a transmittance product): an interior pixel's value
    # is its containing triangle's sigmoid, so seam gradients cancel and
    # only silhouette edges leave a net gradient
    return torch.amax(soft, dim=0)


def _hard(edges, setup, ok, z_floor):
    """The chunk's nearest covering fragment behind z_floor: (depth,
    chunk-local argmin), inf where none."""
    e0, e1, e2 = edges
    za, zb, zc, area = setup[3:]
    abs_area = area.abs()[:, None, None]
    # epsilon-inclusive edge test: a sample exactly on a shared edge may
    # round to outside for both triangles (a crack); the slack is ~1e-6 of
    # the area, and double claims resolve by the z argmin
    eps = 1e-6 * torch.clamp(abs_area, min=1e-3)
    cover = (e0 >= -eps) & (e1 >= -eps) & (e2 >= -eps) & ok
    denom = torch.where(abs_area < 1e-12, torch.ones_like(abs_area), abs_area)
    a0, a1 = e0 / denom, e1 / denom
    a2 = 1.0 - a0 - a1
    z = a0 * za[:, None, None] + a1 * zb[:, None, None] + a2 * zc[:, None, None]
    z = torch.where(cover & (z > z_floor[None]), z, torch.full_like(z, float("inf")))
    return torch.amin(z, dim=0), torch.argmin(z, dim=0)


class _Chunk(torch.autograd.Function):
    """One chunk of the sweep: (soft coverage, depth, argmin), the soft
    channel differentiable in the corners (T, 3, 4).  The backward
    recomputes the chunk's soft channel instead of keeping its (T, H, W)
    intermediates."""

    @staticmethod
    def forward(ctx, corners, cmask, px, py, z_floor, sigma):
        H, W = px.shape
        edges, setup, ok = _edges(corners, cmask, px, py)
        cz, carg = _hard(edges, setup, ok, z_floor)
        ctx.save_for_backward(corners, cmask, px, py)
        ctx.sigma = sigma
        ctx.mark_non_differentiable(cz, carg)
        return _soft(edges, setup, ok, H, W, sigma), cz, carg

    @staticmethod
    def backward(ctx, grad, _cz, _carg):
        corners, cmask, px, py = ctx.saved_tensors
        H, W = px.shape
        with torch.enable_grad():
            c = corners.detach().requires_grad_(True)
            out = _soft(*_edges(c, cmask, px, py), H, W, ctx.sigma)
            (g,) = torch.autograd.grad(out, c, grad)
        return g, None, None, None, None, None


def _sweep(v_clip, tris, tri_mask, z_floor, resolution, chunk: int, with_soft: bool,
           sigma: float):
    """One z-buffer sweep; z_floor (H, W) excludes fragments at or in front
    of it (depth peeling; -inf for the first layer).  Returns (best_z,
    best_id, alpha_soft), alpha_soft differentiable in v_clip."""
    H, W = resolution
    dev = v_clip.device
    px, py = _pixel_grid(H, W, dev)
    T = tris.shape[0]
    best_z = torch.full((H, W), float("inf"), device=dev)
    best_id = torch.zeros((H, W), dtype=torch.int64, device=dev)
    soft_agg = torch.zeros((H, W), device=dev)
    for s in range(0, T, chunk):
        ctris = tris[s:s + chunk]
        cmask = tri_mask[s:s + chunk]
        if ctris.shape[0] < chunk:  # the padding of the last chunk
            pad = chunk - ctris.shape[0]
            ctris = torch.cat([ctris, ctris.new_zeros((pad, 3))])
            cmask = torch.cat([cmask, cmask.new_zeros(pad)])
        if with_soft:
            csoft, cz, carg = _Chunk.apply(v_clip[ctris], cmask, px, py, z_floor, sigma)
            soft_agg = torch.maximum(soft_agg, csoft)
        else:
            with torch.no_grad():
                cz, carg = _hard(*_edges(v_clip.detach()[ctris], cmask, px, py), z_floor)
        take = cz < best_z
        best_z = torch.where(take, cz, best_z)
        best_id = torch.where(take, carg + (s + 1), best_id)
    alpha_soft = soft_agg if with_soft else (best_id > 0).float()
    return best_z, best_id, alpha_soft


def _resolve_bary(v_clip, tris, tri_id, resolution):
    """Differentiable barycentrics of the (detached) winning triangle."""
    H, W = resolution
    px, py = _pixel_grid(H, W, v_clip.device)
    idx = torch.clamp(tri_id - 1, 0, tris.shape[0] - 1)
    vert = v_clip[tris[idx]]  # (H, W, 3, 4)
    w = torch.clamp(vert[..., 3], min=1e-9)
    p = vert[..., :2] / w[..., None]
    pa, pb, pc = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def edge2(p0, p1):
        return ((p1[..., 0] - p0[..., 0]) * (py - p0[..., 1])
                - (p1[..., 1] - p0[..., 1]) * (px - p0[..., 0]))

    e0, e1, e2 = edge2(pb, pc), edge2(pc, pa), edge2(pa, pb)
    ssum = e0 + e1 + e2
    ssum = torch.where(ssum.abs() < 1e-12, torch.full_like(ssum, 1e-12), ssum)
    a0, a1, a2 = e0 / ssum, e1 / ssum, e2 / ssum
    # perspective correction
    q0, q1, q2 = a0 / w[..., 0], a1 / w[..., 1], a2 / w[..., 2]
    qs = q0 + q1 + q2
    qs = torch.where(qs.abs() < 1e-20, torch.full_like(qs, 1e-20), qs)
    zw = (a0 * vert[..., 0, 2] / w[..., 0] + a1 * vert[..., 1, 2] / w[..., 1]
          + a2 * vert[..., 2, 2] / w[..., 2])
    return q1 / qs, q2 / qs, zw


def rasterize(v_clip, tris, resolution, tri_mask: Optional[torch.Tensor] = None,
              num_layers: int = 1, chunk: Optional[int] = None, soft_sigma: float = 1.0,
              with_soft: bool = True):
    """-> list of `Rast`, front layer first.

    v_clip (V, 4) clip-space positions (differentiable), tris (T, 3) int,
    tri_mask optional (T,) bool validity for capacity-padded buffers."""
    H, W = resolution
    v_clip = v_clip.float()  # the sweep carries are float32
    tris = tris.long()
    if tri_mask is None:
        tri_mask = torch.ones(tris.shape[0], dtype=torch.bool, device=tris.device)
    if chunk is None:
        chunk = default_chunk(H, W)
    layers = []
    z_floor = torch.full((H, W), -float("inf"), device=v_clip.device)
    for _ in range(num_layers):
        best_z, best_id, alpha_soft = _sweep(v_clip, tris, tri_mask, z_floor, (H, W), chunk,
                                             with_soft, soft_sigma)
        u, v, zw = _resolve_bary(v_clip, tris, best_id, (H, W))
        empty = best_id == 0
        zero = u.new_zeros(())
        u = torch.where(empty, zero, u)
        v = torch.where(empty, zero, v)
        zw = torch.where(empty, torch.full_like(zw, float("inf")), zw)
        hard = (~empty).float()
        if with_soft:
            # straight-through coverage: the exact hard value, the soft
            # channel's gradient at silhouettes
            alpha = (hard - alpha_soft).detach() + alpha_soft
        else:
            alpha = hard
        layers.append(Rast(u=u, v=v, zw=zw, tri_id=best_id, alpha_soft=alpha))
        z_floor = torch.where(empty, z_floor, best_z * (1 + 1e-6) + 1e-7)
        with_soft = False  # soft coverage only for the silhouette
    return layers


def interpolate(attr, rast: Rast, tris):
    """attr (V, C) vertex attributes -> (H, W, C), zero where empty."""
    idx = torch.clamp(rast.tri_id - 1, 0, tris.shape[0] - 1)
    av = attr[tris[idx].long()]  # (H, W, 3, C)
    w0 = (1.0 - rast.u - rast.v)[..., None]
    out = w0 * av[..., 0, :] + rast.u[..., None] * av[..., 1, :] + rast.v[..., None] * av[..., 2, :]
    return torch.where((rast.tri_id > 0)[..., None], out, torch.zeros_like(out))


def interpolate_face(face_attr, rast: Rast):
    """face_attr (T, C) per-face attributes -> (H, W, C) flat lookup."""
    out = face_attr[torch.clamp(rast.tri_id - 1, 0, face_attr.shape[0] - 1)]
    return torch.where((rast.tri_id > 0)[..., None], out, torch.zeros_like(out))
