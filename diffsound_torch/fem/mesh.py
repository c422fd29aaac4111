"""Tetrahedral mesh container and host-side mesh IO / preprocessing.

Numpy copy of `diffsound_tpu.fem.mesh` (the port never imports the JAX
package).  Mesh preprocessing runs once per mesh on the host; its outputs
become the static index tensors of the element operators.

Order-2 promotion numbers the new edge nodes in first-seen order (tet-major,
edge-minor), exactly as the JAX package's native `promote_order2` does, so
both packages build bit-identical order-2 meshes.
"""

from __future__ import annotations

import os
import struct
import subprocess
from dataclasses import dataclass, replace

import numpy as np

from .shape_func import CORNER_NODES, num_nodes_for_order

# ---------------------------------------------------------------------------
# gmsh 2.2 (ASCII + binary) minimal reader / writer — tetra / tetra10 cells
# ---------------------------------------------------------------------------

_GMSH_TET_TYPES = {4: 4, 11: 10, 29: 20}  # element type -> nodes per element
_GMSH_TYPE_FOR_ORDER = {1: 4, 2: 11, 3: 29}
_GMSH_NODES_PER_TYPE = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9, 11: 10,
    12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20, 18: 15, 19: 13, 29: 20,
}


def read_msh(path: str):
    """Read a gmsh 2.2 file (binary or ASCII).  Returns (vertices, tets).

    Only tetrahedral cells are returned (the largest tet block found).
    """
    with open(path, "rb") as f:
        data = f.read()

    def find_section(name):
        start = data.find(b"$" + name)
        if start < 0:
            raise ValueError(f"missing ${name.decode()} section in {path}")
        start = data.index(b"\n", start) + 1
        end = data.find(b"$End" + name)
        return start, end

    hdr_s, hdr_e = find_section(b"MeshFormat")
    version, ftype, dsize = data[hdr_s:hdr_e].split()[:3]
    binary = int(ftype) == 1

    node_s, node_e = find_section(b"Nodes")
    line_end = data.index(b"\n", node_s)
    num_nodes = int(data[node_s:line_end])
    verts = np.zeros((num_nodes, 3), dtype=np.float64)

    if binary:
        off = line_end + 1
        rec = np.dtype([("id", "<i4"), ("xyz", "<f8", (3,))])
        arr = np.frombuffer(data, dtype=rec, count=num_nodes, offset=off)
        ids = arr["id"].astype(np.int64) - 1
        verts[ids] = arr["xyz"]
    else:
        tokens = data[line_end + 1 : node_e].split()
        arr = np.array(tokens, dtype=np.float64).reshape(num_nodes, 4)
        verts[arr[:, 0].astype(np.int64) - 1] = arr[:, 1:]

    elem_s, elem_e = find_section(b"Elements")
    line_end = data.index(b"\n", elem_s)
    num_elems = int(data[elem_s:line_end])
    tet_blocks = []

    if binary:
        off = line_end + 1
        read = 0
        while read < num_elems:
            etype, nfollow, ntags = struct.unpack_from("<3i", data, off)
            off += 12
            nnodes = _GMSH_NODES_PER_TYPE[etype]
            stride = 1 + ntags + nnodes
            block = np.frombuffer(
                data, dtype="<i4", count=nfollow * stride, offset=off
            ).reshape(nfollow, stride)
            off += nfollow * stride * 4
            read += nfollow
            if etype in _GMSH_TET_TYPES:
                tet_blocks.append(block[:, 1 + ntags :].astype(np.int64) - 1)
    else:
        tokens = data[line_end + 1 : elem_e].split()
        i = 0
        for _ in range(num_elems):
            etype = int(tokens[i + 1])
            ntags = int(tokens[i + 2])
            nnodes = _GMSH_NODES_PER_TYPE[etype]
            if etype in _GMSH_TET_TYPES:
                conn = [int(t) - 1 for t in tokens[i + 3 + ntags : i + 3 + ntags + nnodes]]
                tet_blocks.append(np.array(conn, dtype=np.int64)[None])
            i += 3 + ntags + nnodes

    if not tet_blocks:
        raise ValueError(f"no tetrahedral cells in {path}")
    widths = [b.shape[1] for b in tet_blocks]
    width = max(set(widths), key=lambda w: sum(b.shape[0] for b in tet_blocks if b.shape[1] == w))
    tets = np.concatenate([b for b in tet_blocks if b.shape[1] == width], axis=0)
    return verts, tets


def write_msh(path: str, vertices: np.ndarray, tets: np.ndarray, order: int = 1):
    """Write an ASCII gmsh 2.2 file with tetra/tetra10/tetra20 cells."""
    etype = _GMSH_TYPE_FOR_ORDER[order]
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{len(vertices)}\n")
        for i, v in enumerate(vertices):
            f.write(f"{i + 1} {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{len(tets)}\n")
        for i, t in enumerate(tets):
            conn = " ".join(str(int(x) + 1) for x in t)
            f.write(f"{i + 1} {etype} 2 0 0 {conn}\n")
        f.write("$EndElements\n")


def read_obj(path: str):
    """Minimal Wavefront OBJ reader -> (vertices (n,3) f64, faces (m,3) i64)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(verts, dtype=np.float64), np.array(faces, dtype=np.int64)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in faces:
            f.write(f"f {int(t[0]) + 1} {int(t[1]) + 1} {int(t[2]) + 1}\n")



def surface_triangles(tets: np.ndarray) -> np.ndarray:
    """The boundary triangles of a tet mesh (N, 4): the faces that appear in
    one tet only, each with its tet's vertex order."""
    faces = np.concatenate([tets[:, [0, 1, 2]], tets[:, [0, 1, 3]], tets[:, [0, 2, 3]],
                            tets[:, [1, 2, 3]]])
    _, inv, counts = np.unique(np.sort(faces, axis=1), axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]

def read_comsol_txt(path: str):
    """COMSOL text export: comment lines (%), vertex block, %-line, tet block
    with 1-based indices."""
    verts, tets = [], []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines) and lines[i].startswith("%"):
        i += 1
    while i < len(lines) and not lines[i].startswith("%"):
        verts.append([float(x) for x in lines[i].split()])
        i += 1
    while i < len(lines) and lines[i].startswith("%"):
        i += 1
    while i < len(lines):
        tets.append([int(x) - 1 for x in lines[i].split()])
        i += 1
    return np.array(verts, dtype=np.float64), np.array(tets, dtype=np.int64)


# ---------------------------------------------------------------------------
# TetMesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TetMesh:
    """Immutable host-side tetrahedral mesh (order 1, 2 or 3).

    vertices: (num_vertices, 3) float64
    tets:     (num_tets, nodes_per_tet) int64 — node ordering per
              `fem.shape_func` (order-2: corners at columns 0, 2, 4, 9).
    """

    vertices: np.ndarray
    tets: np.ndarray
    order: int = 1

    def __post_init__(self):
        expect = num_nodes_for_order(self.order)
        if self.tets.shape[1] != expect:
            raise ValueError(
                f"order-{self.order} mesh needs {expect} nodes/tet, got {self.tets.shape[1]}"
            )

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_tets(self) -> int:
        return self.tets.shape[0]

    def __repr__(self):
        return (
            f"TetMesh(vertices={self.vertices.shape}, tets={self.tets.shape}, "
            f"order={self.order})"
        )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_file(path: str, keep_order: bool = False) -> "TetMesh":
        """Load a tet mesh from .msh (gmsh 2.2) or COMSOL .txt.

        keep_order=False (default): high-order cells are reduced to their
        corner vertices and returned as an order-1 mesh (re-promote with
        `to_high_order`).  keep_order=True returns the mesh at its native
        order."""
        if path.endswith(".txt"):
            v, t = read_comsol_txt(path)
        else:
            v, t = read_msh(path)
        width = t.shape[1]
        if width == 4:
            return TetMesh(v, t, order=1).remove_duplicate_vertices()
        if width not in (10, 20):
            raise ValueError(f"unsupported tet cell width {width}")
        order = 2 if width == 10 else 3
        if keep_order:
            return TetMesh(v, t, order=order).remove_duplicate_vertices()
        corners = t[:, list(CORNER_NODES[order])]
        return TetMesh(v, corners, order=1).remove_unreferenced_vertices().remove_duplicate_vertices()

    @staticmethod
    def from_triangle_mesh(path: str, log: bool = False) -> "TetMesh":
        """Tetrahedralize a triangle mesh via fTetWild, caching `<path>_.msh`.
        If the cache exists the external binary is never invoked."""
        cached = path + "_.msh"
        if not os.path.exists(cached):
            result = subprocess.run(
                ["FloatTetwild_bin", "-i", path, "--max-threads", "8", "--coarsen"],
                capture_output=True,
                text=True,
            )
            if log:
                print(result.stdout, result.stderr)
            if not os.path.exists(cached):
                raise FileNotFoundError(
                    f"fTetWild did not produce {cached}; install FloatTetwild_bin "
                    "or provide a pre-tetrahedralized .msh"
                )
        return TetMesh.from_file(cached)

    # -- transforms ---------------------------------------------------------

    def corner_tets(self) -> np.ndarray:
        """(num_tets, 4) corner-vertex indices regardless of order."""
        return self.tets[:, list(CORNER_NODES[self.order])]

    def transform_matrices(self) -> np.ndarray:
        """Per-tet affine A = [v1-v4 | v2-v4 | v3-v4] (num_tets, 3, 3)."""
        c = self.corner_tets()
        v = self.vertices
        v1, v2, v3, v4 = v[c[:, 0]], v[c[:, 1]], v[c[:, 2]], v[c[:, 3]]
        return np.stack([v1 - v4, v2 - v4, v3 - v4], axis=-1)

    def volumes(self) -> np.ndarray:
        """Per-tet volumes |det A| / 6."""
        return np.abs(np.linalg.det(self.transform_matrices())) / 6.0

    def to_high_order(self, order: int) -> "TetMesh":
        """Promote an order-1 mesh to order `order` by inserting unique edge
        (and for order 3, face) nodes.  Order-2 node layout:
        [c0, m01, c1, m12, c2, m02, m03, m13, m23, c3]."""
        if self.order != 1:
            raise ValueError("to_high_order expects an order-1 mesh")
        if order == 1:
            return self
        if order == 3:
            return self._to_order3()
        if order != 2:
            raise NotImplementedError(f"unsupported order {order}")

        t = self.tets
        # edges in the promoted node layout: positions 1,3,5,6,7,8
        edge_pairs = np.array([[0, 1], [1, 2], [0, 2], [0, 3], [1, 3], [2, 3]])
        edges = np.sort(t[:, edge_pairs].reshape(-1, 2), axis=1)  # (E*6, 2)
        uniq, first, inverse = np.unique(
            edges, axis=0, return_index=True, return_inverse=True
        )
        # renumber unique edges in order of first appearance
        seen_order = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), np.int64)
        rank[seen_order] = np.arange(len(uniq))
        ordered = uniq[seen_order]
        mid = 0.5 * (self.vertices[ordered[:, 0]] + self.vertices[ordered[:, 1]])
        new_vertices = np.concatenate([self.vertices, mid], axis=0)
        edge_node = self.num_vertices + rank[inverse.reshape(-1)].reshape(-1, 6)

        new_tets = np.empty((self.num_tets, 10), dtype=np.int64)
        new_tets[:, 0] = t[:, 0]
        new_tets[:, 1] = edge_node[:, 0]  # m01
        new_tets[:, 2] = t[:, 1]
        new_tets[:, 3] = edge_node[:, 1]  # m12
        new_tets[:, 4] = t[:, 2]
        new_tets[:, 5] = edge_node[:, 2]  # m02
        new_tets[:, 6] = edge_node[:, 3]  # m03
        new_tets[:, 7] = edge_node[:, 4]  # m13
        new_tets[:, 8] = edge_node[:, 5]  # m23
        new_tets[:, 9] = t[:, 3]
        return TetMesh(new_vertices, new_tets, order=2)

    def _to_order3(self) -> "TetMesh":
        """Order-1 -> order-3 (tetra20): two nodes per unique edge at the
        third points plus one node per unique face (centroid), deduped by
        integer keys.  Node layout matches `fem.shape_func` order 3: corners
        at 0/3/6/16; edge nodes (1,2)=c0c1, (4,5)=c1c2, (7,8)=c2c0,
        (10,13)=c0c3, (11,14)=c1c3, (12,15)=c2c3 (first of each pair nearest
        the first corner); face nodes 9=f012, 17=f123, 18=f023, 19=f013."""
        t = self.tets
        V = self.num_vertices
        E = self.num_tets

        # slot -> (edge index into edge_pairs, first corner of that edge,
        #          fraction-from-first-corner numerator: 1 or 2 thirds)
        slot_info = {
            1: (0, 0, 1), 2: (0, 0, 2), 4: (1, 1, 1), 5: (1, 1, 2),
            7: (2, 2, 1), 8: (2, 2, 2), 10: (3, 0, 1), 13: (3, 0, 2),
            11: (4, 1, 1), 14: (4, 1, 2), 12: (5, 2, 1), 15: (5, 2, 2),
        }
        edge_pairs = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]])
        ed = t[:, edge_pairs]  # (E, 6, 2) endpoint vertex ids
        a, b = ed[..., 0], ed[..., 1]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        key_lo = np.stack([lo, hi], -1).reshape(-1, 2)  # (E*6, 2)
        uniq_e, inv_e = np.unique(key_lo, axis=0, return_inverse=True)
        inv_e = inv_e.reshape(E, 6)
        third = (
            2.0 * self.vertices[uniq_e[:, 0]] + self.vertices[uniq_e[:, 1]]
        ) / 3.0  # at 1/3 from lo
        two_third = (
            self.vertices[uniq_e[:, 0]] + 2.0 * self.vertices[uniq_e[:, 1]]
        ) / 3.0
        ne = len(uniq_e)

        face_corners = np.array([[0, 1, 2], [1, 2, 3], [0, 2, 3], [0, 1, 3]])
        fc = np.sort(t[:, face_corners], axis=-1).reshape(-1, 3)
        uniq_f, inv_f = np.unique(fc, axis=0, return_inverse=True)
        inv_f = inv_f.reshape(E, 4)
        centroids = self.vertices[uniq_f].mean(axis=1)

        new_vertices = np.concatenate(
            [self.vertices, third, two_third, centroids], axis=0
        )
        new_tets = np.empty((E, 20), dtype=np.int64)
        new_tets[:, 0] = t[:, 0]
        new_tets[:, 3] = t[:, 1]
        new_tets[:, 6] = t[:, 2]
        new_tets[:, 16] = t[:, 3]
        for slot, (edge_i, ca, frac) in slot_info.items():
            e_idx = inv_e[:, edge_i]
            av = t[:, ca]
            lo_e = uniq_e[e_idx, 0]
            # node sits at frac/3 from corner a; measured from the LOW
            # endpoint the fraction flips when a is the high endpoint
            from_lo_is_third = (av == lo_e) == (frac == 1)
            new_tets[:, slot] = np.where(
                from_lo_is_third, V + e_idx, V + ne + e_idx
            )
        new_tets[:, 9] = V + 2 * ne + inv_f[:, 0]   # f012
        new_tets[:, 17] = V + 2 * ne + inv_f[:, 1]  # f123
        new_tets[:, 18] = V + 2 * ne + inv_f[:, 2]  # f023
        new_tets[:, 19] = V + 2 * ne + inv_f[:, 3]  # f013
        return TetMesh(new_vertices, new_tets, order=3)

    def remove_duplicate_vertices(self) -> "TetMesh":
        uniq, inverse = np.unique(self.vertices, axis=0, return_inverse=True)
        return TetMesh(uniq, inverse.reshape(-1)[self.tets], order=self.order)

    def remove_unreferenced_vertices(self) -> "TetMesh":
        used, inverse = np.unique(self.tets.reshape(-1), return_inverse=True)
        return TetMesh(
            self.vertices[used], inverse.reshape(self.tets.shape), order=self.order
        )

    def largest_connected_component(self) -> "TetMesh":
        """Keep only the largest vertex-connected component (marching tets
        can leave islands that make the mass matrix singular)."""
        import scipy.sparse as sp

        c = self.corner_tets()
        rows = np.concatenate([c[:, 0], c[:, 1], c[:, 2], c[:, 3]])
        cols = np.concatenate([c[:, 1], c[:, 2], c[:, 3], c[:, 0]])
        A = sp.coo_matrix(
            (np.ones_like(rows, dtype=np.float32), (rows, cols)),
            shape=(self.num_vertices, self.num_vertices),
        )
        n_comp, labels = sp.csgraph.connected_components(A, directed=False)
        if n_comp == 1:
            return self
        largest = np.bincount(labels, minlength=n_comp).argmax()
        keep_tet = np.all(labels[c] == largest, axis=1)
        return TetMesh(self.vertices, self.tets[keep_tet], self.order).remove_unreferenced_vertices()

    def scaled(self, factor: float) -> "TetMesh":
        return replace(self, vertices=self.vertices * factor)

    def export(self, path: str):
        write_msh(path, self.vertices, self.tets, order=self.order)


def cube_tet_mesh(n: int = 2, size: float = 1.0) -> TetMesh:
    """Regular n^3-cell cube mesh, 6 tets per cell (Kuhn subdivision)."""
    xs = np.linspace(0.0, size, n + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    corner_offsets = [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
    ]
    kuhn = [
        (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
        (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
    ]
    tets = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                ids = [vid(i + di, j + dj, k + dk) for (di, dj, dk) in corner_offsets]
                for a, b, c, d in kuhn:
                    tets.append([ids[a], ids[b], ids[c], ids[d]])
    return TetMesh(verts, np.array(tets, dtype=np.int64), order=1)


def icosphere(subdiv: int = 2, radius: float = 1.0):
    """Closed triangle mesh of a sphere: the icosahedron, each face split in
    four `subdiv` times, vertices pushed out to `radius`.
    -> (vertices (n, 3) f64, faces (m, 3) i64); 642 vertices and 1280
    faces at subdiv 3."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [np.array(v, dtype=np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    )]
    faces = [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ]
    for _ in range(subdiv):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append((verts[a] + verts[b]) / 2)
                mid[key] = len(verts) - 1
            return mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new_faces
    verts = np.array(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts, np.array(faces, dtype=np.int64)
