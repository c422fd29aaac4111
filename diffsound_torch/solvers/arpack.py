"""Host-side shift-invert ARPACK fallback / cross-check.

Parity with the reference's solver path
(the reference's src/diffelastic/diff_model.py:335-369): scipy
`eigsh(K, M=M, k=k, sigma=sigma)` in shift-invert mode.  Used for
validation against the on-device LOBPCG and as a robust fallback for
ill-conditioned meshes.  Host only (numpy/scipy).
"""

from __future__ import annotations

import numpy as np


def eigsh_shift_invert(K, M, k: int, sigma: float = 20000.0):
    """Smallest-k generalized eigenpairs of sparse (K, M) near sigma.

    Returns (eigenvalues (k,), eigenvectors (n, k)) ascending, float64.
    """
    import scipy.sparse.linalg as spla

    # Fixed start vector: ARPACK otherwise seeds from global RNG state,
    # which makes solves (and anything warm-started from them, e.g. the
    # device LOBPCG refresh iteration count) run-to-run nondeterministic.
    v0 = np.random.default_rng(0).standard_normal(K.shape[0])
    vals, vecs = spla.eigsh(K, M=M, k=k, sigma=sigma, v0=v0)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]
