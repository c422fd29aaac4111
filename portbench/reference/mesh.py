"""The benchmark's meshes, made from the configuration alone (numpy).

A cube of `cells`^3 cells, each split into six tetrahedra (Kuhn), and its
order-2 promotion with one node per unique edge.  The order-2 node layout
is the one the measured program's shape functions read:

    [c0, m01, c1, m12, c2, m02, m03, m13, m23, c3]

Both the program and the plain reference receive the arrays made here, so
their degrees of freedom are numbered alike.
"""

from __future__ import annotations

import numpy as np

_CORNERS = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                     (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)])
_KUHN = np.array([(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
                  (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)])
# (corner, corner) of the edge node in each order-2 slot 1, 3, 5, 6, 7, 8
_EDGES = np.array([(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)])
_EDGE_SLOTS = (1, 3, 5, 6, 7, 8)
_CORNER_SLOTS = (0, 2, 4, 9)


def cube(cells: int, size: float):
    """(vertices (V, 3) float64, tets (6 cells^3, 4) int64)."""
    xs = np.linspace(0.0, size, cells + 1)
    verts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    ijk = np.stack(np.meshgrid(*(np.arange(cells),) * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    c = ijk[:, None, :] + _CORNERS[None, :, :]  # (cells^3, 8, 3)
    vid = (c[..., 0] * (cells + 1) + c[..., 1]) * (cells + 1) + c[..., 2]
    tets = vid[:, _KUHN].reshape(-1, 4)
    return verts, tets.astype(np.int64)


def promote_order2(verts: np.ndarray, tets: np.ndarray):
    """Order-1 (V, 3), (E, 4) -> order-2 vertices and (E, 10) tets: a new
    node at the midpoint of every unique edge, numbered after the corners
    in order of first appearance."""
    edges = np.sort(tets[:, _EDGES].reshape(-1, 2), axis=1)
    uniq, first, inverse = np.unique(edges, axis=0, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    ordered = np.empty_like(uniq)
    ordered[rank] = uniq
    mid = 0.5 * (verts[ordered[:, 0]] + verts[ordered[:, 1]])
    out = np.empty((len(tets), 10), np.int64)
    out[:, list(_CORNER_SLOTS)] = tets
    out[:, list(_EDGE_SLOTS)] = len(verts) + rank[inverse.reshape(-1)].reshape(-1, 6)
    return np.concatenate([verts, mid]), out


def make_mesh(spec: dict, order: int):
    """The configuration's mesh: spec {"kind": "cube", "cells", "size"}."""
    if spec["kind"] != "cube":
        raise ValueError(f"unknown mesh kind {spec['kind']!r}")
    verts, tets = cube(int(spec["cells"]), float(spec["size"]))
    if order == 2:
        verts, tets = promote_order2(verts, tets)
    elif order != 1:
        raise ValueError(f"order {order} is not supported")
    return verts, tets
