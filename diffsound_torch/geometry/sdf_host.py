"""Signed distance of query points to a triangle mesh, in torch.

Counterpart of `diffsound_tpu/geometry/sdf_host.py::mesh_signed_distance`,
with the same arithmetic: exact point-triangle distances (the clamped
barycentric projection and the three edges, least of the four candidates)
and the inside/outside sign by ray-casting parity with a majority vote over
three ray directions drawn from `numpy.random.default_rng(12345)`.

It runs on the entry point's device, chunked over the query points: at grid
64 the background grid has 274,625 vertices, and the JAX package's numpy
version takes about a minute per mesh on a CPU.  On the CPU in float64 it
gives the JAX package's values.

Convention: INSIDE-POSITIVE.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# (query points x faces) pairs per chunk: about 1 GiB of float64 temporaries
# on the card, a tenth of it on the CPU
_PAIRS_PER_CHUNK = {"cuda": 1 << 23, "cpu": 1 << 20}


def _dot(x, y):
    """Sum over the last axis of 3, added as (x0 y0 + x2 y2) + x1 y1: the
    order of numpy's einsum for these contractions, so that values (and the
    sign decisions built on them) agree bit for bit."""
    return (x[..., 0] * y[..., 0] + x[..., 2] * y[..., 2]) + x[..., 1] * y[..., 1]


def _cross(x, y):
    """numpy.cross's formula, for the same rounding."""
    return torch.stack([
        x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0],
    ], dim=-1)


def _sqrt(x):
    """Correctly rounded square root.  CUDA's float64 sqrt is; torch's
    vectorised CPU sqrt can land an ulp off, so the CPU takes numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _point_triangle_dist2(P, A, B, C):
    """Squared distances of points P (Q, 3) to triangles (A, B, C) (F, 3)
    -> (Q, F)."""
    E0 = B - A  # (F, 3)
    E1 = C - A
    D = P[:, None, :] - A[None, :, :]  # (Q, F, 3)
    a = _dot(E0, E0)[None, :]
    b = _dot(E0, E1)[None, :]
    c = _dot(E1, E1)[None, :]
    d = _dot(D, E0[None])
    e = _dot(D, E1[None])
    tiny = 1e-30

    det = torch.clamp(a * c - b * b, min=tiny)
    s = ((c * d - b * e) / det).clamp(0.0, 1.0)
    t = ((a * e - b * d) / det).clamp(0.0, 1.0)
    over = s + t > 1.0
    # project onto the s + t = 1 edge where needed
    ss = torch.where(over, ((c + e - b - d) / torch.clamp(a - 2 * b + c, min=tiny)).clamp(0, 1), s)
    tt = torch.where(over, 1.0 - ss, t)
    ss, tt = ss.clamp(0.0, 1.0), tt.clamp(0.0, 1.0)

    def dist2(Q):
        R = P[:, None] - Q
        return _dot(R, R)

    cand = [dist2(A[None] + ss[..., None] * E0[None] + tt[..., None] * E1[None])]
    # edge s=0: t = clamp(e/c)
    t0 = (e / torch.clamp(c, min=tiny)).clamp(0, 1)
    cand.append(dist2(A[None] + t0[..., None] * E1[None]))
    # edge t=0: s = clamp(d/a)
    s0 = (d / torch.clamp(a, min=tiny)).clamp(0, 1)
    cand.append(dist2(A[None] + s0[..., None] * E0[None]))
    # edge s+t=1: param u along B->C
    CB = C - B
    u = (_dot(D - E0[None], CB[None]) / torch.clamp(_dot(CB, CB), min=tiny)[None]).clamp(0, 1)
    cand.append(dist2(B[None] + u[..., None] * CB[None]))
    return torch.stack(cand, dim=0).amin(dim=0)


def _ray_parity(P, A, B, C, d):
    """Parity of ray-triangle intersection counts (Q,) via Moller-Trumbore,
    along the unit direction d (3,)."""
    E1 = B - A
    E2 = C - A
    h = _cross(d[None, :], E2)  # (F, 3)
    a = _dot(E1, h)[None, :]  # (1, F)
    parallel = a.abs() < 1e-12
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = P[:, None, :] - A[None, :, :]  # (Q, F, 3)
    u = f * _dot(s, h[None])
    q = _cross(s, E1[None, :, :])
    v = f * _dot(q, d)
    t = f * _dot(q, E2[None])
    hit = (~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-10)
    return hit.sum(dim=1) % 2 == 1


def mesh_signed_distance(query, verts, faces, device="cuda") -> torch.Tensor:
    """Inside-positive signed distance (Q,) float64 on `device` of `query`
    (Q, 3) to the triangle mesh (verts (N, 3), faces (F, 3)); numpy or
    tensor inputs."""
    dev = resolve_device(device)
    as64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    verts = as64(verts)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    A, B, C = (verts[faces[:, i]] for i in range(3))
    query = as64(query)
    dirs = np.random.default_rng(12345).standard_normal((3, 3))
    dirs = as64([d / np.linalg.norm(d) for d in dirs])
    chunk = max(1, _PAIRS_PER_CHUNK.get(dev.type, 1 << 20) // max(len(faces), 1))
    out = []
    for i in range(0, query.shape[0], chunk):
        qs = query[i : i + chunk]
        dist = _sqrt(_point_triangle_dist2(qs, A, B, C).amin(dim=1))
        votes = sum(_ray_parity(qs, A, B, C, d).to(torch.int64) for d in dirs)
        out.append(torch.where(votes >= 2, dist, -dist))
    return torch.cat(out)
