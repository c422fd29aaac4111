"""Marching-tetrahedra subdivision tables, derived programmatically.

Local numbering inside one background tet: vertices 0..3, edge midpoints
4..9 in the order [01, 02, 03, 12, 13, 23] (same edge ordering as the
reference's base_tet_edges, its src/dmtet/geometry/dmtet_geometry.py:
59-61).  For each of the 16 occupancy cases the inside
region is decomposed into at most 3 sub-tetrahedra and its cut surface
into at most 2 triangles:

  |S|=1 (corner):      1 tet  — corner vertex + its 3 cut edge points
  |S|=2 (wedge):       3 tets — staircase split of the 6-vertex prism
  |S|=3 (truncation):  3 tets — prism between the inside face and the cut
  |S|=4 (full):        1 tet  — the tet itself

Unlike the reference's hard-coded tables (dmtet_geometry.py:31-95) these
are generated by the case analysis below; the decompositions are valid
partitions of the same regions (triangulation diagonals may differ —
eigenvalue-level behavior is equivalent).

Numpy copy of `diffsound_tpu/geometry/tables.py`, table for table: the
sub-tet split decides which vertices the marched mesh has, so both packages
must hold the same entries."""

from __future__ import annotations

import numpy as np

EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_EDGE_ID = {e: 4 + i for i, e in enumerate(EDGES)}

MAX_TETS = 3
MAX_TRIS = 2


def edge_id(a: int, b: int) -> int:
    return _EDGE_ID[(min(a, b), max(a, b))]


def _prism_tets(bot, top):
    """Staircase split of a prism given bottom (A,B,C) and top (A',B',C')
    triangles with A-A', B-B', C-C' lateral edges."""
    A, B, C = bot
    A2, B2, C2 = top
    return [(A, B, C, A2), (B, C, A2, B2), (C, A2, B2, C2)]


def _case_subdivision(inside):
    """inside: tuple of 4 bools -> (tets, tris) with local ids."""
    S = [v for v in range(4) if inside[v]]
    O = [v for v in range(4) if not inside[v]]
    if len(S) == 0:
        return [], []
    if len(S) == 4:
        return [(0, 1, 2, 3)], []
    if len(S) == 1:
        v = S[0]
        a, b, c = O
        e = [edge_id(v, a), edge_id(v, b), edge_id(v, c)]
        return [(v, e[0], e[1], e[2])], [(e[0], e[1], e[2])]
    if len(S) == 3:
        w = O[0]
        a, b, c = S
        ea, eb, ec = edge_id(a, w), edge_id(b, w), edge_id(c, w)
        return _prism_tets((a, b, c), (ea, eb, ec)), [(ea, eb, ec)]
    # len(S) == 2
    a, b = S
    c, d = O
    ac, ad = edge_id(a, c), edge_id(a, d)
    bc, bd = edge_id(b, c), edge_id(b, d)
    tets = _prism_tets((a, ac, ad), (b, bc, bd))
    tris = [(ac, ad, bd), (ac, bd, bc)]
    return tets, tris


def build_tables():
    """Returns (num_tets (16,), tet_table (16, MAX_TETS, 4),
    num_tris (16,), tri_table (16, MAX_TRIS, 3)) with -1 padding.
    Case index = sum over inside vertices v of 2**v."""
    num_tets = np.zeros(16, np.int32)
    tet_table = -np.ones((16, MAX_TETS, 4), np.int32)
    num_tris = np.zeros(16, np.int32)
    tri_table = -np.ones((16, MAX_TRIS, 3), np.int32)
    for case in range(16):
        inside = tuple(bool(case >> v & 1) for v in range(4))
        tets, tris = _case_subdivision(inside)
        num_tets[case] = len(tets)
        for i, t in enumerate(tets):
            tet_table[case, i] = t
        num_tris[case] = len(tris)
        for i, t in enumerate(tris):
            tri_table[case, i] = t
    return num_tets, tet_table, num_tris, tri_table


NUM_TETS_TABLE, TET_TABLE, NUM_TRIS_TABLE, TRI_TABLE = build_tables()
