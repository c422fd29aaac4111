"""Gauss quadrature on the reference tetrahedron.

Tensor-product Gauss-Legendre points collapsed onto the reference tet
{x,y,z >= 0, x+y+z <= 1} via the Duffy-style map used by the reference
(cf. the reference's src/diffelastic/gauss.py:17-38):

    w = r_i, z = r_j (1-w), y = r_k (1-w-z), x = 1-w-z-y

with Jacobian (1-w)(1-w-z) and the 1/8 factor from mapping [-1,1]^3 to
[0,1]^3.  The returned points are barycentric 4-vectors (L1,L2,L3,L4) =
(x,y,z,w) and the weights sum to the reference-tet volume 1/6.

Host-side, numpy only: quadrature is static data, built once per order.
"""

import numpy as np
from functools import lru_cache


@lru_cache(maxsize=None)
def gauss_tet_quadrature(order: int):
    """Return (points, weights): points (order**3, 4) barycentric, weights (order**3,)."""
    roots, wts = np.polynomial.legendre.leggauss(order)
    roots = (roots.astype(np.float64) + 1.0) / 2.0  # [0, 1]
    wts = wts.astype(np.float64)

    n = order**3
    pts = np.zeros((n, 4), dtype=np.float64)
    wp = np.zeros((n,), dtype=np.float64)
    idx = 0
    for i in range(order):
        for j in range(order):
            for k in range(order):
                w = roots[i]
                z = roots[j] * (1.0 - w)
                y = roots[k] * (1.0 - w - z)
                x = 1.0 - w - z - y
                pts[idx] = (x, y, z, w)
                wp[idx] = wts[i] * wts[j] * wts[k] * (1.0 - w) * (1.0 - w - z) / 8.0
                idx += 1
    return pts, wp
