"""Lagrange shape functions on the reference tetrahedron (orders 1-3).

Barycentric coordinates L = (L1, L2, L3, L4).  Node ordering follows the
framework's high-order promotion convention (corner/edge interleaved for
order 2), matching the reference's tet10 layout so meshes and element
matrices are directly comparable (cf. the reference's src/diffelastic/
shape_func.py:3-108 and mesh.py:101-160):

order 1 (4 nodes):  [c0, c1, c2, c3]
order 2 (10 nodes): [c0, m01, c1, m12, c2, m02, m03, m13, m23, c3]
order 3 (20 nodes): standard cubic layout with corner nodes at 0, 3, 6, 16.

These are evaluated only at static quadrature points, so plain numpy is
used; the results become constant tensors of the element operators.
"""

import numpy as np

_NUM_NODES = {1: 4, 2: 10, 3: 20}

# Corner-node positions inside the element node list, per order.
CORNER_NODES = {1: (0, 1, 2, 3), 2: (0, 2, 4, 9), 3: (0, 3, 6, 16)}


def num_nodes_for_order(order: int) -> int:
    return _NUM_NODES[order]


def shape_function(L: np.ndarray, order: int = 1) -> np.ndarray:
    """N(L) for points L (n, 4) -> (n, num_nodes)."""
    L = np.asarray(L, dtype=np.float64)
    L1, L2, L3, L4 = L[:, 0], L[:, 1], L[:, 2], L[:, 3]
    if order == 1:
        return L.copy()
    if order == 2:
        cols = [
            L1 * (2 * L1 - 1),
            4 * L1 * L2,
            L2 * (2 * L2 - 1),
            4 * L2 * L3,
            L3 * (2 * L3 - 1),
            4 * L3 * L1,
            4 * L1 * L4,
            4 * L2 * L4,
            4 * L3 * L4,
            L4 * (2 * L4 - 1),
        ]
        return np.stack(cols, axis=1)
    if order == 3:
        cols = [
            0.5 * (3 * L1 - 1) * (3 * L1 - 2) * L1,
            4.5 * L1 * L2 * (3 * L1 - 1),
            4.5 * L1 * L2 * (3 * L2 - 1),
            0.5 * (3 * L2 - 1) * (3 * L2 - 2) * L2,
            4.5 * L2 * L3 * (3 * L2 - 1),
            4.5 * L2 * L3 * (3 * L3 - 1),
            0.5 * (3 * L3 - 1) * (3 * L3 - 2) * L3,
            4.5 * L3 * L1 * (3 * L3 - 1),
            4.5 * L3 * L1 * (3 * L1 - 1),
            27 * L1 * L2 * L3,
            4.5 * L1 * L4 * (3 * L1 - 1),
            4.5 * L2 * L4 * (3 * L2 - 1),
            4.5 * L3 * L4 * (3 * L3 - 1),
            4.5 * L1 * L4 * (3 * L4 - 1),
            4.5 * L2 * L4 * (3 * L4 - 1),
            4.5 * L3 * L4 * (3 * L4 - 1),
            0.5 * (3 * L4 - 1) * (3 * L4 - 2) * L4,
            27 * L2 * L3 * L4,
            27 * L1 * L3 * L4,
            27 * L1 * L2 * L4,
        ]
        return np.stack(cols, axis=1)
    raise ValueError(f"unsupported order {order}")


def shape_function_grad(L: np.ndarray, order: int = 1) -> np.ndarray:
    """Analytic dN/dL at points L (n, 4) -> (n, num_nodes, 4)."""
    L = np.asarray(L, dtype=np.float64)
    n = L.shape[0]
    L1, L2, L3, L4 = L[:, 0], L[:, 1], L[:, 2], L[:, 3]
    one = np.ones_like(L1)
    zero = np.zeros_like(L1)

    def rows(*r):
        # each r_i is a tuple of 4 arrays (dN_i/dL1..dL4)
        return np.stack([np.stack(ri, axis=-1) for ri in r], axis=1)

    if order == 1:
        out = np.zeros((n, 4, 4), dtype=np.float64)
        out[:] = np.eye(4)
        return out
    if order == 2:
        return rows(
            (4 * L1 - one, zero, zero, zero),
            (4 * L2, 4 * L1, zero, zero),
            (zero, 4 * L2 - one, zero, zero),
            (zero, 4 * L3, 4 * L2, zero),
            (zero, zero, 4 * L3 - one, zero),
            (4 * L3, zero, 4 * L1, zero),
            (4 * L4, zero, zero, 4 * L1),
            (zero, 4 * L4, zero, 4 * L2),
            (zero, zero, 4 * L4, 4 * L3),
            (zero, zero, zero, 4 * L4 - one),
        )
    if order == 3:
        return rows(
            (13.5 * L1 * L1 - 9 * L1 + one, zero, zero, zero),
            ((27 * L1 - 4.5) * L2, 4.5 * L1 * (3 * L1 - one), zero, zero),
            (4.5 * L2 * (3 * L2 - one), (27 * L2 - 4.5) * L1, zero, zero),
            (zero, 13.5 * L2 * L2 - 9 * L2 + one, zero, zero),
            (zero, (27 * L2 - 4.5) * L3, 4.5 * L2 * (3 * L2 - one), zero),
            (zero, 4.5 * L3 * (3 * L3 - one), (27 * L3 - 4.5) * L2, zero),
            (zero, zero, 13.5 * L3 * L3 - 9 * L3 + one, zero),
            (4.5 * L3 * (3 * L3 - one), zero, (27 * L3 - 4.5) * L1, zero),
            ((27 * L1 - 4.5) * L3, zero, 4.5 * L1 * (3 * L1 - one), zero),
            (27 * L2 * L3, 27 * L1 * L3, 27 * L1 * L2, zero),
            ((27 * L1 - 4.5) * L4, zero, zero, 4.5 * L1 * (3 * L1 - one)),
            (zero, (27 * L2 - 4.5) * L4, zero, 4.5 * L2 * (3 * L2 - one)),
            (zero, zero, (27 * L3 - 4.5) * L4, 4.5 * L3 * (3 * L3 - one)),
            (4.5 * L4 * (3 * L4 - one), zero, zero, (27 * L4 - 4.5) * L1),
            (zero, 4.5 * L4 * (3 * L4 - one), zero, (27 * L4 - 4.5) * L2),
            (zero, zero, 4.5 * L4 * (3 * L4 - one), (27 * L4 - 4.5) * L3),
            (zero, zero, zero, 13.5 * L4 * L4 - 9 * L4 + one),
            (zero, 27 * L3 * L4, 27 * L2 * L4, 27 * L2 * L3),
            (27 * L3 * L4, zero, 27 * L1 * L4, 27 * L1 * L3),
            (27 * L2 * L4, 27 * L1 * L4, zero, 27 * L1 * L2),
        )
    raise ValueError(f"unsupported order {order}")
