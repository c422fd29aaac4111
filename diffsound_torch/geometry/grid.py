"""Background tetrahedral grids for DMTet.

Loads the reference's quartet-generated npz grids when present
(its data/tets/{16,32,64}_tets.npz: vertices in [-0.5, 0.5]^3; the default
directory is data/tets/ at the repository root)
and can generate an equivalent 6-tet-per-cube grid procedurally so the
framework is self-contained without those assets.  Numpy copy of
`diffsound_tpu/geometry/grid.py`; a missing npz is the documented case for
the procedural grid, not a device fallback."""

from __future__ import annotations

import os

import numpy as np

REFERENCE_TETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "tets",
)


def generate_background_grid(res: int):
    """Regular res^3-cell grid on [-0.5, 0.5]^3, Kuhn 6-tet subdivision.
    Returns (vertices (V, 3) f32, tets (T, 4) i64)."""
    xs = np.linspace(-0.5, 0.5, res + 1, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (res + 1) + j) * (res + 1) + k

    corner = [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
    ]
    kuhn = [
        (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
        (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
    ]
    i, j, k = np.meshgrid(
        np.arange(res), np.arange(res), np.arange(res), indexing="ij"
    )
    cell_ids = np.stack(
        [vid(i + di, j + dj, k + dk).reshape(-1) for (di, dj, dk) in corner], axis=1
    )  # (res^3, 8)
    tets = np.concatenate(
        [cell_ids[:, list(t)] for t in kuhn], axis=0
    ).astype(np.int64)
    return verts, tets


def load_background_grid(res: int, tets_dir: str = REFERENCE_TETS_DIR):
    """Reference npz grid if available, else the procedural grid."""
    path = os.path.join(tets_dir, f"{res}_tets.npz")
    if os.path.exists(path):
        data = np.load(path)
        return (
            np.asarray(data["vertices"], np.float32),
            np.asarray(data["indices"], np.int64),
        )
    return generate_background_grid(res)
