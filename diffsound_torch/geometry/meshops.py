"""Host mesh operations of the marching-tets path, in numpy and scipy.

Counterpart of `diffsound_tpu/native/meshops.py` (the C++ library and its
numpy fallbacks).  The port has one path, this one, and no native library:

* `unique_edges` numbers the edges in first-seen order (tet-major,
  edge-minor), as the native library does, not in sorted order as the JAX
  package's numpy fallback does.  Edge ids decide where each edge point
  sits in `MarchingOutput.all_verts`, and so the compact vertex order and
  the rows ARPACK's fixed start vector lands on: with another order the
  port's compact mesh would be a permutation of the JAX package's.
* `connected_components` counts components among the referenced vertices
  only, as the native union-find does; its labels are scipy's, not the
  union-find's root ids.  They differ only in naming, which matters to
  `MarchingTets.compact` only where two largest components tie in size.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components as _csgraph_components

_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def unique_edges(tets: np.ndarray):
    """(num_tets, 4) -> (unique_edges (E, 2) sorted pairs in first-seen
    order, tet_edge_ids (num_tets, 6))."""
    tets = np.ascontiguousarray(tets, np.int64)
    pairs = np.sort(tets[:, _TET_EDGES].reshape(-1, 2), axis=1)
    base = int(pairs.max()) + 1 if len(pairs) else 1
    key = pairs[:, 0] * base + pairs[:, 1]
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # sorted-key ids -> first-seen rank
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return pairs[first[order]], rank[inverse.reshape(-1)].reshape(-1, 6)


def connected_components(tets: np.ndarray, num_verts: int):
    """-> (ncomp among referenced vertices, labels (num_verts,)) over tet
    corner connectivity; unreferenced vertices get labels of their own."""
    tets = np.ascontiguousarray(tets, np.int64)
    rows = np.concatenate([tets[:, 0]] * 3)
    cols = tets[:, 1:].T.reshape(-1)
    A = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(num_verts, num_verts)
    )
    _, labels = _csgraph_components(A, directed=False)
    used = np.unique(tets.reshape(-1))
    return int(len(np.unique(labels[used]))), labels.astype(np.int64)


def compact_tets(tets: np.ndarray):
    """Densely relabel the vertices of tets (sorted unique order).
    -> (keep_ids (Vc,), tets_compact (Tc, 4))."""
    used, inv = np.unique(np.asarray(tets).reshape(-1), return_inverse=True)
    return used.astype(np.int64), inv.reshape(-1, 4).astype(np.int64)


def face_connected_components(tets: np.ndarray):
    """-> (ncomp, tet_labels (T,)) over shared-FACE adjacency.

    Vertex connectivity treats two bodies touching at a single vertex or
    edge as one component, but such joints are mechanisms (free relative
    rotation) that add spurious near-zero eigenvalues beyond the 6 rigid
    modes.  Only a shared triangular face transmits stiffness, so the
    largest face-connected component is the mechanically meaningful body."""
    tets = np.ascontiguousarray(tets, np.int64)
    T = len(tets)
    if T == 0:
        return 0, np.zeros(0, np.int64)
    # 4 faces per tet, canonicalized by sorting the 3 vertex ids
    fidx = [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
    faces = np.concatenate([np.sort(tets[:, f], axis=1) for f in fidx])
    owner = np.tile(np.arange(T), 4)
    order = np.lexsort(faces.T)
    faces, owner = faces[order], owner[order]
    same = np.all(faces[1:] == faces[:-1], axis=1)
    a, b = owner[:-1][same], owner[1:][same]  # face-sharing tet pairs
    A = sp.coo_matrix((np.ones(len(a), np.float32), (a, b)), shape=(T, T))
    n, labels = _csgraph_components(A, directed=False)
    return int(n), labels.astype(np.int64)
