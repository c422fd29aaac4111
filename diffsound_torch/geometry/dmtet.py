"""Differentiable marching tetrahedra emitting a *tetrahedral* mesh.

Counterpart of `diffsound_tpu/geometry/dmtet.py` (`MarchingOutput`,
`MarchingTets.__call__`, `compact`, `compact_triangles`):

  * the background grid's unique-edge structure is precomputed once on the
    host, so the device pass has no dynamic shapes: every grid edge gets an
    interpolated point, every background tet up to MAX_TETS sub-tets via
    the derived case tables, with validity masks;
  * vertex positions (grid + edge points) are differentiable with respect
    to the SDF values and the thickness scalar (the zero crossing of sdf,
    or of sdf - thickness on edges with both ends inside);
  * host-side `compact()` extracts the concrete submesh, bucket-padded, for
    the eigensolver; the differentiable vertices are re-gathered through
    its keep-index (`MarchingTets.vertices`).

The interpolation weight is clipped as `minimum(maximum(x, 0), 1)`, whose
derivative at a bound is 1/2 in reverse and forward mode alike, as JAX's
`clip` is; `torch.clamp`'s is 1 there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from . import meshops
from .tables import MAX_TETS, MAX_TRIS, NUM_TETS_TABLE, NUM_TRIS_TABLE, TET_TABLE, TRI_TABLE


# the compact mesh's padding buckets (the JAX package bounds its jit
# specializations with them; here they fix the shapes the eigensolver sees)
TET_BUCKET, VERT_BUCKET = 4096, 1024


class MarchingOutput(NamedTuple):
    all_verts: torch.Tensor  # (V + Eg, 3) grid verts + edge points
    sub_tets: torch.Tensor  # (T * MAX_TETS, 4) int32, global vertex ids
    tet_mask: torch.Tensor  # (T * MAX_TETS,) bool
    surf_tris: torch.Tensor  # (T * MAX_TRIS, 3) int32
    tri_mask: torch.Tensor  # (T * MAX_TRIS,) bool


def _local_table(table: np.ndarray) -> np.ndarray:
    """Case table with the -1 padding sent to local id 4 (the tet's first
    edge point), where the JAX package's clipped gathers send it."""
    return np.where(table < 0, 4, table)


class MarchingTets:
    """Marching tets over a fixed background grid (static topology)."""

    def __init__(self, grid_verts: np.ndarray, grid_tets: np.ndarray, device="cuda"):
        self.device = resolve_device(device)
        self.grid_verts = np.asarray(grid_verts, np.float64)
        self.grid_tets = np.asarray(grid_tets, np.int64)
        V = self.grid_verts.shape[0]
        self.unique_edges, self.tet_edges = meshops.unique_edges(self.grid_tets)
        self.num_grid_verts = V
        self.num_edges = self.unique_edges.shape[0]

        dev = self.device
        self._edges = torch.as_tensor(self.unique_edges, device=dev)
        self._tets = torch.as_tensor(self.grid_tets, device=dev)
        # local ids 0..3 are the tet's corners, 4..9 its edge points (+V)
        self._local = torch.cat(
            [self._tets, torch.as_tensor(self.tet_edges, device=dev) + V], dim=1
        ).to(torch.int32)
        self._tet_table = torch.as_tensor(_local_table(TET_TABLE), dtype=torch.int64, device=dev)
        self._num_tets_t = torch.as_tensor(NUM_TETS_TABLE, dtype=torch.int64, device=dev)
        self._tri_table = torch.as_tensor(_local_table(TRI_TABLE), dtype=torch.int64, device=dev)
        self._num_tris_t = torch.as_tensor(NUM_TRIS_TABLE, dtype=torch.int64, device=dev)

    def _edge_points(self, pos, sdf, thickness, edges):
        """Interpolated zero crossing on each of `edges` (n, 2)."""
        ea, eb = edges[:, 0], edges[:, 1]
        sa, sb = sdf[ea], sdf[eb]
        if thickness is not None:
            both_pos = (sa > 0) & (sb > 0)
            sa = torch.where(both_pos, sa - thickness, sa)
            sb = torch.where(both_pos, sb - thickness, sb)
        denom = sa - sb
        denom = torch.where(denom.abs() < 1e-20, torch.full_like(denom, 1e-20), denom)
        zero, one = sa.new_zeros(()), sa.new_ones(())
        t = torch.minimum(torch.maximum(sa / denom, zero), one)
        pa = pos[ea]
        return pa + t[:, None] * (pos[eb] - pa)

    def __call__(self, pos, sdf, thickness: Optional[torch.Tensor] = None) -> MarchingOutput:
        """pos (V, 3), sdf (V,); thickness: None for the solid occupancy
        sdf > 0, or a scalar for the shell 0 < sdf <= thickness."""
        if thickness is None:
            occ = sdf > 0
        else:
            occ = (sdf > 0) & (sdf <= thickness)
        all_verts = torch.cat([pos, self._edge_points(pos, sdf, thickness, self._edges)], dim=0)

        weights = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=occ.device)
        case = (occ[self._tets].to(torch.int64) * weights).sum(dim=1)  # (T,)
        T = self._tets.shape[0]

        def expand(table, counts, width):
            entries = table[case].reshape(T, -1)  # (T, width * n) local ids
            glob = torch.gather(self._local, 1, entries).reshape(T * width, -1)
            n = counts[case]
            mask = torch.arange(width, device=case.device)[None, :] < n[:, None]
            return glob, mask.reshape(-1)

        sub, sub_mask = expand(self._tet_table, self._num_tets_t, MAX_TETS)
        tris, tri_mask = expand(self._tri_table, self._num_tris_t, MAX_TRIS)
        return MarchingOutput(all_verts, sub, sub_mask, tris, tri_mask)

    def vertices(self, pos, sdf, thickness, rows) -> torch.Tensor:
        """`__call__(pos, sdf, thickness).all_verts[rows]`, computing only
        those rows (the same arithmetic, so the same values)."""
        rows = torch.as_tensor(rows, device=pos.device)
        V = self.num_grid_verts
        edges = self._edges[torch.clamp(rows - V, min=0)]
        pts = self._edge_points(pos, sdf, thickness, edges)
        return torch.where((rows >= V)[:, None], pts, pos[torch.clamp(rows, max=V - 1)])

    # -- host-side compaction ----------------------------------------------

    @staticmethod
    def compact(out: MarchingOutput):
        """Extract the valid submesh on the host, keep the largest connected
        component (vertex, then face connectivity), and pad it to buckets
        of TET_BUCKET tets and VERT_BUCKET vertices.

        Only the valid sub-tets and their corner positions leave the device.

        Returns dict with:
          keep_idx  (Vc_pad,) int — rows of all_verts (padded: repeat 0)
          tets      (Tc_pad, 4) int — indices into keep_idx rows
          tet_mask  (Tc_pad,) bool
          num_verts, num_tets — actual (unpadded) counts
        """
        with torch.no_grad():
            valid_t = out.sub_tets[out.tet_mask]
            corners = out.all_verts.detach()[valid_t.long()].to(torch.float64)
            valid = valid_t.cpu().numpy()
            a, b, c, d = np.moveaxis(corners.cpu().numpy(), 1, 0)

        # drop (near-)zero-volume slivers: cut points coinciding with grid
        # vertices create degenerate sub-tets whose dangling vertices would
        # make the mass matrix exactly singular
        vols = np.abs(np.einsum("ij,ij->i", a - d, np.cross(b - d, c - d))) / 6.0
        if len(vols):
            valid = valid[vols > 1e-9 * vols.max()]

        if len(valid):
            ncomp, labels = meshops.connected_components(valid, out.all_verts.shape[0])
            if ncomp > 1:
                roots = labels[valid[:, 0]]
                uniq_roots, counts = np.unique(roots, return_counts=True)
                valid = valid[roots == uniq_roots[counts.argmax()]]
            # refine by FACE connectivity: a chunk attached through only a
            # vertex or edge is a hinge (spurious near-zero eigenvalues)
            nf, tlabels = meshops.face_connected_components(valid)
            if nf > 1:
                uniq, counts = np.unique(tlabels, return_counts=True)
                valid = valid[tlabels == uniq[counts.argmax()]]

        used, tets_c = meshops.compact_tets(valid)
        num_verts, num_tets = len(used), len(tets_c)

        def round_up(x, b):
            return ((x + b - 1) // b) * b

        vpad = round_up(num_verts, VERT_BUCKET)
        tpad = round_up(num_tets, TET_BUCKET)
        keep_idx = np.zeros(vpad, np.int64)
        keep_idx[:num_verts] = used
        tets_pad = np.zeros((tpad, 4), np.int64)
        tets_pad[:num_tets] = tets_c
        tet_mask = np.zeros(tpad, bool)
        tet_mask[:num_tets] = True
        return {
            "keep_idx": keep_idx,
            "tets": tets_pad,
            "tet_mask": tet_mask,
            "num_verts": num_verts,
            "num_tets": num_tets,
        }

    @staticmethod
    def compact_triangles(out: MarchingOutput):
        """Surface triangle mesh (host): (verts (Vs,3) f64, tris (F,3))."""
        with torch.no_grad():
            tris = out.surf_tris[out.tri_mask].cpu().numpy()
            used, inv = np.unique(tris.reshape(-1), return_inverse=True)
            verts = out.all_verts.detach()[torch.as_tensor(used, device=out.all_verts.device)]
        return verts.to(torch.float64).cpu().numpy(), inv.reshape(-1, 3)
