"""Geometry and image regularizers.

Counterpart of `diffsound_tpu/render/regularizer.py`: the jittered image
gradient, the umbrella Laplacian, average edge length and edge-based normal
consistency.  The JAX package's `segment_sum`s are `mesh.vertex_sum`."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import face_normals, vertex_sum
from .texture import sample_bilinear
from .util import dot, length


def image_grad(buf, generator: Optional[torch.Generator] = None, std: float = 0.01,
               noise: Optional[torch.Tensor] = None):
    """Expected local image gradient by jittered resampling; buf (H, W, C+1)
    with alpha last.  The jitter is `noise` (H, W, 2) when given, else a
    standard normal draw from `generator`."""
    H, W = buf.shape[0], buf.shape[1]
    gy, gx = torch.meshgrid((torch.arange(H, dtype=buf.dtype, device=buf.device) + 0.5) / H,
                            (torch.arange(W, dtype=buf.dtype, device=buf.device) + 0.5) / W,
                            indexing="ij")
    uv = torch.stack([gx, gy], -1)
    if noise is None:
        noise = torch.randn(uv.shape, generator=generator, dtype=buf.dtype, device=buf.device)
    tap = sample_bilinear(buf, uv + std * noise.to(buf))
    return (tap[..., :-1] - buf[..., :-1]).abs() * tap[..., -1:] * buf[..., -1:]


def avg_edge_length(v_pos, unique_edges):
    e = torch.as_tensor(unique_edges, device=v_pos.device).long()
    return length(v_pos[e[:, 0]] - v_pos[e[:, 1]]).mean()


def laplace_regularizer_const(v_pos, t_pos_idx, gidx: Optional[torch.Tensor] = None):
    """Mean squared umbrella-operator Laplacian; `gidx` is the transpose of
    t_pos_idx for the card (`mesh.gather_index`)."""
    V = v_pos.shape[0]
    t = t_pos_idx.long()
    v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    # corner-major rows (corner i of every face, then i + 1), regrouped
    # face-major as vertex_sum takes them
    contrib = torch.stack([(v1 - v0) + (v2 - v0), (v0 - v1) + (v2 - v1), (v0 - v2) + (v1 - v2)], 1)
    term = vertex_sum(contrib.reshape(-1, 3), t, V, gidx)
    norm = vertex_sum(torch.full((3 * t.shape[0], 1), 2.0, dtype=v_pos.dtype, device=v_pos.device),
                      t, V, gidx)
    return ((term / torch.clamp(norm, min=1.0)) ** 2).mean()


def edge_to_face_mapping(t_pos_idx) -> np.ndarray:
    """Host precompute: each unique edge's first and last adjacent face (its
    two on a manifold mesh); a boundary edge pairs its face with itself."""
    t = np.asarray(t_pos_idx.cpu() if torch.is_tensor(t_pos_idx) else t_pos_idx)
    F = t.shape[0]
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0), axis=1)
    face_of = np.tile(np.arange(F), 3)
    _, inv = np.unique(e, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")  # occurrences of each edge in input order
    first = np.ones(len(order), bool)
    first[1:] = inv[order][1:] != inv[order][:-1]
    pairs = np.full((inv.max() + 1, 2), -1, np.int64)
    pairs[inv[order][first], 0] = face_of[order][first]
    later = np.r_[first[1:], True] & ~first  # an edge's last occurrence after its first
    pairs[inv[order][later], 1] = face_of[order][later]
    pairs[:, 1] = np.where(pairs[:, 1] < 0, pairs[:, 0], pairs[:, 1])
    return pairs


def normal_consistency(v_pos, t_pos_idx, tris_per_edge):
    """Mean misalignment of adjacent face normals; tris_per_edge from
    `edge_to_face_mapping`."""
    fn = face_normals(v_pos, t_pos_idx)
    te = torch.as_tensor(tris_per_edge, device=v_pos.device).long()
    term = torch.clamp(dot(fn[te[:, 0]], fn[te[:, 1]]), -1.0, 1.0)
    return ((1.0 - term) * 0.5).abs().mean()
