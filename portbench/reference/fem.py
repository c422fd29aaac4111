"""Plain tetrahedral FEM for isotropic linear elasticity (torch, float64).

Element blocks, independent of the material, for K = mu K_mu + lam K_lam
and the consistent mass matrix at unit density:

    K_lam[(a,i),(b,j)] = int d_i N_a d_j N_b
    K_mu [(a,i),(b,j)] = delta_ij int grad N_a . grad N_b + int d_j N_a d_i N_b
    M    [(a,i),(b,j)] = delta_ij int N_a N_b

with Lagrange shape functions of order 1 or 2 in barycentric coordinates
(node layout of `reference/mesh.py`) and a collapsed Gauss-Legendre rule of
order + 2 points a direction.  Applies are a gather, a batched product and
an index_add_; the host assembly feeds the cold shift-invert solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_CORNER_SLOTS = {1: (0, 1, 2, 3), 2: (0, 2, 4, 9)}


def quadrature(n: int):
    """(points (n^3, 4) barycentric, weights (n^3,)) on the reference tet
    {L1, L2, L3 >= 0, L1 + L2 + L3 <= 1}; the weights sum to 1/6."""
    r, w = np.polynomial.legendre.leggauss(n)
    r, w = (r + 1.0) / 2.0, w / 2.0
    u, v, s = (a.reshape(-1) for a in np.meshgrid(r, r, r, indexing="ij"))
    wu, wv, ws = (a.reshape(-1) for a in np.meshgrid(w, w, w, indexing="ij"))
    L1 = u
    L2 = v * (1.0 - u)
    L3 = s * (1.0 - u) * (1.0 - v)
    pts = np.stack([L1, L2, L3, 1.0 - L1 - L2 - L3], axis=1)
    return pts, wu * wv * ws * (1.0 - u) ** 2 * (1.0 - v)


def shape(L: np.ndarray, order: int):
    """(N (G, nodes), dN/dL (G, nodes, 4)) at barycentric points L (G, 4)."""
    G = L.shape[0]
    if order == 1:
        return L.copy(), np.broadcast_to(np.eye(4), (G, 4, 4)).copy()
    if order != 2:
        raise ValueError(f"order {order} is not supported")
    # slot -> the corner (vertex node) or the edge (pair of corners)
    nodes = [(0,), (0, 1), (1,), (1, 2), (2,), (0, 2), (0, 3), (1, 3), (2, 3), (3,)]
    N = np.empty((G, 10))
    dN = np.zeros((G, 10, 4))
    for a, nd in enumerate(nodes):
        if len(nd) == 1:
            k = nd[0]
            N[:, a] = L[:, k] * (2.0 * L[:, k] - 1.0)
            dN[:, a, k] = 4.0 * L[:, k] - 1.0
        else:
            p, q = nd
            N[:, a] = 4.0 * L[:, p] * L[:, q]
            dN[:, a, p] = 4.0 * L[:, q]
            dN[:, a, q] = 4.0 * L[:, p]
    return N, dN


@dataclass
class Elements:
    """Element blocks of one mesh on one device (float64)."""

    tets: torch.Tensor  # (E, N) int64
    k_mu: torch.Tensor  # (E, 3N, 3N)
    k_lam: torch.Tensor  # (E, 3N, 3N)
    mass: torch.Tensor  # (E, N, N) at unit density
    num_vertices: int


def elements(verts: np.ndarray, tets: np.ndarray, order: int, device="cpu") -> Elements:
    dt = torch.float64
    pts, wq = quadrature(order + 2)
    Nq, dNq = shape(pts, order)
    X = torch.as_tensor(verts, dtype=dt, device=device)
    T = torch.as_tensor(tets, dtype=torch.int64, device=device)
    c = T[:, list(_CORNER_SLOTS[order])]
    v0, v1, v2, v3 = (X[c[:, k]] for k in range(4))
    A = torch.stack([v0 - v3, v1 - v3, v2 - v3], dim=-1)  # x = A L123 + v3
    Ainv = torch.linalg.inv(A)
    gradL = torch.cat([Ainv, -Ainv.sum(dim=1, keepdim=True)], dim=1)  # (E, 4, 3)
    B = torch.einsum("gnk,ekj->egnj", torch.as_tensor(dNq, dtype=dt, device=device), gradL)
    w = torch.as_tensor(wq, dtype=dt, device=device)[None, :] * torch.linalg.det(A).abs()[:, None]
    E, G, N, _ = B.shape
    Tn = torch.einsum("eg,egai,egbj->eaibj", w, B, B)  # (E, N, 3, N, 3)
    eye = torch.eye(3, dtype=dt, device=device)
    lap = torch.einsum("eapbp->eab", Tn)
    k_mu = lap[:, :, None, :, None] * eye[None, None, :, None, :] + Tn.permute(0, 1, 4, 3, 2)
    mref = torch.as_tensor((Nq.T * wq) @ Nq, dtype=dt, device=device)
    mass = torch.linalg.det(A).abs()[:, None, None] * mref[None]
    return Elements(T, k_mu.reshape(E, 3 * N, 3 * N), Tn.reshape(E, 3 * N, 3 * N), mass,
                    int(verts.shape[0]))


def _gather(el: Elements, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    E, N = el.tets.shape
    return x.reshape(el.num_vertices, 3, c)[el.tets].reshape(E, 3 * N, c)


def _scatter(el: Elements, ye: torch.Tensor) -> torch.Tensor:
    E, N = el.tets.shape
    c = ye.shape[-1]
    out = torch.zeros(el.num_vertices, 3 * c, dtype=ye.dtype, device=ye.device)
    out.index_add_(0, el.tets.reshape(-1), ye.reshape(E * N, 3 * c))
    return out.reshape(3 * el.num_vertices, c)


def apply_k_parts(el: Elements, x: torch.Tensor):
    """(K_mu x, K_lam x) for x (3V, c)."""
    xe = _gather(el, x)
    return _scatter(el, torch.bmm(el.k_mu, xe)), _scatter(el, torch.bmm(el.k_lam, xe))


def apply_m(el: Elements, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    E, N = el.tets.shape
    xe = x.reshape(el.num_vertices, 3, c)[el.tets].reshape(E, N, 3 * c)
    return _scatter(el, torch.bmm(el.mass, xe).reshape(E, 3 * N, c))


def assemble(el: Elements, mu: float, lam: float):
    """(K, M) as scipy CSR matrices on the host."""
    import scipy.sparse as sp

    tets = el.tets.cpu().numpy()
    E, N = tets.shape
    dof = (tets[:, :, None] * 3 + np.arange(3)).reshape(E, 3 * N)
    rows = np.repeat(dof, 3 * N, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 3 * N)).reshape(-1)
    n = 3 * el.num_vertices
    ke = (mu * el.k_mu + lam * el.k_lam).cpu().numpy()
    me = torch.einsum("eab,ij->eaibj", el.mass, torch.eye(3, dtype=el.mass.dtype,
                                                           device=el.mass.device))
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    M = sp.coo_matrix((me.cpu().numpy().reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    return K, M


def lowest_modes(el: Elements, mu: float, lam: float, k: int, sigma: float = 2.0e4):
    """The k smallest eigenpairs of K x = theta M x by host shift-invert
    ARPACK (a fixed start vector): (theta (k,), X (3V, k)) float64 numpy,
    ascending, M-orthonormal."""
    import scipy.sparse.linalg as spla

    K, M = assemble(el, mu, lam)
    v0 = np.random.default_rng(0).standard_normal(K.shape[0])
    vals, vecs = spla.eigsh(K, M=M, k=k, sigma=sigma, v0=v0)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]
