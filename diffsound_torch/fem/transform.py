"""Reference <-> world coordinate maps for tetrahedra.

Counterpart of `diffsound_tpu/fem/transform.py`: the per-tet affine
A = [v1-v4 | v2-v4 | v3-v4], b = v4 maps reference coordinates p_hat (the
first three barycentric coordinates) to world points p = A p_hat + b; the
inverse map uses the closed-form adjugate 3x3 inverse
(`fem.assembly.inv3x3`)."""

from __future__ import annotations

import torch

from .assembly import inv3x3


def compute_transform_coord(p, A, b):
    """World -> reference: p (N, 3), A (N, 3, 3), b (N, 3) -> p_hat (N, 3)."""
    _, A_inv = inv3x3(A)
    return torch.einsum("nij,nj->ni", A_inv, p - b)


def compute_inv_transform_coord(p_hat, A, b):
    """Reference -> world: p = A p_hat + b."""
    return torch.einsum("nij,nj->ni", A, p_hat) + b


def barycentric_coordinates(p, A, b):
    """Full barycentric coordinates (N, 4): [p_hat, 1 - sum(p_hat)]."""
    ph = compute_transform_coord(p, A, b)
    return torch.cat([ph, 1.0 - ph.sum(dim=-1, keepdim=True)], dim=-1)
