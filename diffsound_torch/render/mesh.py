"""Triangle mesh record and differentiable normals and tangents.

Counterpart of `diffsound_tpu/render/mesh.py`: an immutable `Mesh`
(positions, texcoords, normals, tangents, each with its own index buffer,
and a material dict), smooth normals and MikkTSpace-style tangents.  The
JAX package's `segment_sum`s are `vertex_sum`: `index_add_` on the CPU, a
gather-sum through a host-built transpose on the card (no atomics, so the
sums do not vary from run to run)."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..fem.assembly import gather_sum, padded_gather_transpose
from .util import dot, safe_normalize


@dataclass(frozen=True)
class Mesh:
    v_pos: Optional[torch.Tensor] = None  # (V, 3)
    t_pos_idx: Optional[torch.Tensor] = None  # (T, 3) int
    v_nrm: Optional[torch.Tensor] = None
    t_nrm_idx: Optional[torch.Tensor] = None
    v_tex: Optional[torch.Tensor] = None  # (Vt, 2)
    t_tex_idx: Optional[torch.Tensor] = None
    v_tng: Optional[torch.Tensor] = None
    t_tng_idx: Optional[torch.Tensor] = None
    material: Optional[dict] = None

    def with_(self, **kw) -> "Mesh":
        return replace(self, **kw)

    def to(self, device) -> "Mesh":
        """The mesh with every tensor on `device`."""
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)
                                if torch.is_tensor(getattr(self, f.name))})


def gather_index(tris, num_vertices: int, num_real: Optional[int] = None) -> torch.Tensor:
    """The transpose of `tris` (T, 3) for `vertex_sum` on the card
    (`fem.assembly.padded_gather_transpose` of its first `num_real`
    triangles, all of them by default)."""
    t = np.asarray(tris.cpu() if torch.is_tensor(tris) else tris)
    gidx = padded_gather_transpose(t, len(t) if num_real is None else num_real, num_vertices)
    return torch.as_tensor(gidx, dtype=torch.int64,
                           device=tris.device if torch.is_tensor(tris) else "cpu")


def vertex_sum(rows, tris, num_vertices: int, gidx: Optional[torch.Tensor] = None):
    """Sum of per-corner rows (3 T, C), row 3 t + i at vertex tris[t, i],
    into (V, C): `index_add_` on the CPU; on the card `fem.assembly.gather_sum`
    through `gidx` (`gather_index`, built here when not given)."""
    if rows.is_cuda:
        return gather_sum(rows, gather_index(tris, num_vertices) if gidx is None else gidx)
    out = rows.new_zeros(num_vertices, rows.shape[1])
    return out.index_add_(0, tris.reshape(-1).long(), rows)


def aabb(mesh: Mesh):
    return mesh.v_pos.amin(dim=0), mesh.v_pos.amax(dim=0)


def unit_size(mesh: Mesh) -> Mesh:
    """Centre on the origin and scale the longest AABB side to 2."""
    vmin, vmax = aabb(mesh)
    scale = 2.0 / (vmax - vmin).max()
    return mesh.with_(v_pos=(mesh.v_pos - (vmax + vmin) / 2) * scale)


def center_by_reference(mesh: Mesh, ref_aabb, scale: float) -> Mesh:
    center = (ref_aabb[0] + ref_aabb[1]) * 0.5
    s = scale / (ref_aabb[1] - ref_aabb[0]).max()
    return mesh.with_(v_pos=(mesh.v_pos - center[None, :]) * s)


def face_normals(v_pos, t_pos_idx, normalize: bool = True):
    t = t_pos_idx.long()
    v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    return safe_normalize(fn) if normalize else fn


def auto_normals(mesh: Mesh, gidx: Optional[torch.Tensor] = None) -> Mesh:
    """Area-weighted smooth vertex normals."""
    V = mesh.v_pos.shape[0]
    fn = face_normals(mesh.v_pos, mesh.t_pos_idx, normalize=False)
    v_nrm = vertex_sum(fn.repeat_interleave(3, dim=0), mesh.t_pos_idx, V, gidx)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v_nrm.dtype, device=v_nrm.device)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm, up)
    return mesh.with_(v_nrm=safe_normalize(v_nrm), t_nrm_idx=mesh.t_pos_idx)


def compute_tangents(mesh: Mesh, gidx: Optional[torch.Tensor] = None) -> Mesh:
    """Per-vertex tangents from the UVs (MikkTSpace-style accumulation);
    `gidx` is the transpose of t_nrm_idx."""
    tp, tt = mesh.t_pos_idx.long(), mesh.t_tex_idx.long()
    pos = [mesh.v_pos[tp[:, i]] for i in range(3)]
    tex = [mesh.v_tex[tt[:, i]] for i in range(3)]
    uve1, uve2 = tex[1] - tex[0], tex[2] - tex[0]
    pe1, pe2 = pos[1] - pos[0], pos[2] - pos[0]
    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    tang = nom / torch.where(denom > 0.0, torch.clamp(denom, min=1e-6),
                             torch.clamp(denom, max=-1e-6))
    V = mesh.v_nrm.shape[0]
    tangents = safe_normalize(vertex_sum(tang.repeat_interleave(3, dim=0), mesh.t_nrm_idx, V,
                                         gidx))
    tangents = safe_normalize(tangents - dot(tangents, mesh.v_nrm) * mesh.v_nrm)
    return mesh.with_(v_tng=tangents, t_tng_idx=mesh.t_nrm_idx)


def unique_edges(t_pos_idx) -> np.ndarray:
    """Host-side unique undirected edges (sorted pairs, sorted rows)."""
    t = np.asarray(t_pos_idx.cpu() if torch.is_tensor(t_pos_idx) else t_pos_idx)
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0), axis=1)
    return np.unique(e, axis=0)
