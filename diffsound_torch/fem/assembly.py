"""Matrix-free high-order tet FEM operators in plain PyTorch.

Isotropic linear elasticity factors the element stiffness exactly as

    K_e = mu * K_e^mu + lambda * K_e^lam,

with material-independent dense blocks (num_tets, 3N, 3N) precomputed once
from the geometry:

    T[a,i,b,j]         = sum_g w_g B[g,a,i] B[g,b,j]
    K^lam[(a,i),(b,j)] = T[a,i,b,j]
    K^mu [(a,i),(b,j)] = delta_ij * sum_p T[a,p,b,p]  +  T[a,j,b,i]

where B (gauss, nodes, 3) are world-space shape-function gradients and w
the per-(tet, gauss) integration weights (gauss weight x |det A|).  K @ X
is an index gather of each element's (3N, k) slab, a batched matmul
(`torch.bmm`, TF32 off), and a deterministic gather-sum over the elements
sharing each vertex (`gather_idx`, no atomics).  The mass operator uses the
reference-element mass matrix Mref (nodes, nodes) scaled by |det A| per tet.

Everything is a torch function of `vertices`, so vertex gradients flow
through A^-1, |det A| and the element blocks.  A `tet_mask` turns padded
elements into zero contributions.

Counterpart of `diffsound_tpu/fem/assembly.py`; the split-bf16 einsums of
the JAX package (`fem/precision.py`) are a TPU workaround and are not
carried over: f32 with TF32 off is exact f32 on the GPU.

While `utils.profiler.tracing()` is open, each K apply is a
`diffsound.fem.k_apply` span and each M apply a `diffsound.fem.m_apply`
span, and both count their calls and columns (`fem.k_apply.calls`,
`fem.k_apply.cols`, `fem.m_apply.*`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.profiler import count, span
from .quadrature import gauss_tet_quadrature
from .shape_func import CORNER_NODES, num_nodes_for_order, shape_function, shape_function_grad

# dL/dx maps reference-coordinate gradients to barycentric: x = A [L1 L2 L3]^T + v4.
_DL_DX = np.array(
    [[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [-1, -1, -1]], dtype=np.float64
)


def inv3x3(A: torch.Tensor, safe: bool = False):
    """Batched closed-form 3x3 (det, inverse) via the adjugate.

    safe=True replaces |det| < 1e-25 by 1 in the division, so masked-out
    degenerate elements give finite values that their zeroed integration
    weights then annihilate (1e-25 is ~10 orders below any real element
    determinant and exactly representable in f32)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    if safe:
        den = torch.where(det.abs() < 1e-25, torch.ones_like(det), det)
        return det, adj / den[..., None, None]
    return det, adj / det[..., None, None]


@dataclass(frozen=True)
class ElementOps:
    """Precomputed per-element operator data (all tensors on one device)."""

    tets: torch.Tensor  # (E, N) int64 node indices
    k_mu: torch.Tensor  # (E, 3N, 3N)
    k_lam: torch.Tensor  # (E, 3N, 3N)
    mass_scale: torch.Tensor  # (E,) = |det A| (density applied at matvec time)
    mref: torch.Tensor  # (N, N) reference element mass matrix
    num_vertices: int
    # scatter->gather transpose: (V, D) indices into the flattened
    # (E*N + 1) element-node rows (the last row is a zero dummy)
    gather_idx: Optional[torch.Tensor] = None

    @property
    def num_tets(self):
        return self.tets.shape[0]

    @property
    def nodes_per_tet(self):
        return self.tets.shape[1]


def reference_mass_matrix(order: int) -> np.ndarray:
    """Mref_ab = int_ref N_a N_b  (nodes, nodes), quadrature order+2."""
    pts, wts = gauss_tet_quadrature(order + 2)
    N = shape_function(pts, order)  # (G, nodes)
    return (N.T * wts) @ N


def shape_grad_table(order: int) -> np.ndarray:
    """dN/dL @ dL/dx at the quadrature points: (G, nodes, 3) constant."""
    pts, _ = gauss_tet_quadrature(order + 2)
    dNdL = shape_function_grad(pts, order)  # (G, nodes, 4)
    return dNdL @ _DL_DX  # (G, nodes, 3)


def build_gather_transpose(tets: np.ndarray, num_vertices: int) -> np.ndarray:
    """Host-side scatter->gather transposition: for each vertex, the list of
    flattened (element, node-slot) rows that accumulate into it, padded with
    a dummy index pointing at an all-zero row."""
    tets = np.asarray(tets)
    flat = tets.reshape(-1).astype(np.int64)
    counts = np.bincount(flat, minlength=num_vertices)
    D = max(int(counts.max()), 1)
    starts = np.zeros(num_vertices + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    pos = np.arange(len(flat)) - starts[sorted_v]
    idx = np.full((num_vertices, D), len(flat), np.int32)  # dummy row
    idx[sorted_v, pos] = order.astype(np.int32)
    return idx


def padded_gather_transpose(elements, num_real: int, num_vertices: int) -> np.ndarray:
    """`build_gather_transpose` of a bucket-padded element array (E_pad, N),
    built from its first `num_real` rows only (padding would inflate vertex
    0's valence), with the dummy index pointing at the zero row after all
    N * E_pad rows."""
    elements = np.asarray(elements)
    idx = build_gather_transpose(elements[:num_real], num_vertices)
    return np.where(idx == elements.shape[1] * num_real, elements.size, idx)


def build_element_ops(
    vertices: torch.Tensor,
    tets,
    order: int,
    dtype: Optional[torch.dtype] = None,
    tet_mask: Optional[torch.Tensor] = None,
    gather_idx=None,
) -> ElementOps:
    """Differentiable element-operator construction.

    vertices: (V, 3) tensor on the target device; tets: (E, N) int (numpy or
    tensor); tet_mask: optional (E,) — masked-out tets contribute exactly
    zero to both K and M.  dtype defaults to the vertices' dtype.
    gather_idx: optional prebuilt scatter->gather transpose (V, D) whose
    dummy entries point at row E*N; by default it is built from all of
    `tets`.  Bucket-padded meshes pass one built from their real tets, so
    the padding's repeated vertex 0 does not set the depth D."""
    order = int(order)
    n_nodes = num_nodes_for_order(order)
    device = vertices.device
    dtype = vertices.dtype if dtype is None else dtype
    tets_np = np.asarray(tets.cpu() if torch.is_tensor(tets) else tets, np.int64)
    if tets_np.shape[1] != n_nodes:
        raise ValueError(f"tets has {tets_np.shape[1]} nodes, order {order} needs {n_nodes}")
    tets_t = torch.as_tensor(tets_np, device=device)

    vertices = vertices.to(dtype)
    _, wts = gauss_tet_quadrature(order + 2)
    wts = torch.as_tensor(wts, dtype=dtype, device=device)  # (G,)
    dndx_ref = torch.as_tensor(shape_grad_table(order), dtype=dtype, device=device)  # (G, N, 3)

    c = tets_t[:, list(CORNER_NODES[order])]  # (E, 4)
    v1, v2, v3, v4 = (vertices[c[:, i]] for i in range(4))
    A = torch.stack([v1 - v4, v2 - v4, v3 - v4], dim=-1)  # (E, 3, 3)
    detA, A_inv = inv3x3(A, safe=True)
    absdet = detA.abs()

    # World-space shape gradients per (tet, gauss): B[e,g,a,:] = dndx_ref[g,a,:] @ A_inv[e]
    B = torch.einsum("gak,ekj->egaj", dndx_ref, A_inv)  # (E, G, N, 3)
    w = wts[None, :] * absdet[:, None]  # (E, G)
    if tet_mask is not None:
        w = w * tet_mask.to(dtype)[:, None]

    E_, G_, N_ = B.shape[0], B.shape[1], B.shape[2]
    Bw = (B * w[:, :, None, None]).reshape(E_, G_, N_ * 3)
    Bf = B.reshape(E_, G_, N_ * 3)
    T = torch.bmm(Bw.transpose(1, 2), Bf).reshape(E_, N_, 3, N_, 3)
    G = T.diagonal(dim1=2, dim2=4).sum(-1)  # (E, N, N): sum_p T[a,p,b,p]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    k_mu = G[:, :, None, :, None] * eye3[None, None, :, None, :] + T.permute(0, 1, 4, 3, 2)

    mass_scale = absdet if tet_mask is None else absdet * tet_mask.to(dtype)
    nv = int(vertices.shape[0])
    gidx = build_gather_transpose(tets_np, nv) if gather_idx is None else gather_idx
    return ElementOps(
        tets=tets_t,
        k_mu=k_mu.reshape(E_, 3 * N_, 3 * N_),
        k_lam=T.reshape(E_, 3 * N_, 3 * N_),
        mass_scale=mass_scale,
        mref=torch.as_tensor(reference_mass_matrix(order), dtype=dtype, device=device),
        num_vertices=nv,
        gather_idx=torch.as_tensor(gidx, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Matrix-free matvecs (the LOBPCG / Rayleigh-correction hot path)
# ---------------------------------------------------------------------------


def _gather(ops: ElementOps, x: torch.Tensor) -> torch.Tensor:
    """(3V, k) -> per-element (E, 3N, k)."""
    k = x.shape[1]
    xe = x.reshape(ops.num_vertices, 3, k)[ops.tets]  # (E, N, 3, k)
    E, N = ops.tets.shape
    return xe.reshape(E, 3 * N, k)


def gather_sum(flat: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """(R, c) rows -> (V, c): each vertex's rows summed through gather_idx
    (V, D), whose dummy index R points at a zero row; no atomics."""
    rows = torch.cat([flat, flat.new_zeros(1, flat.shape[1])], dim=0)
    # index_select + sum is rows[gather_idx].sum(1) bit for bit, and faster
    # than advanced indexing
    V, D = gather_idx.shape
    return rows.index_select(0, gather_idx.reshape(-1)).reshape(V, D, -1).sum(dim=1)


def _scatter(ops, ye: torch.Tensor) -> torch.Tensor:
    """per-element (E, 3N, k) -> (3V, k) for ElementOps or DeformOps: the
    sum over the element-node rows of each vertex, deterministic on every
    device: on the card the gather-sum through gather_idx (a scatter-add
    there would use atomics); on the CPU index_add_, sequential there and
    without the gather's (V, D, 3k) intermediate (D is the largest valence:
    14 times less time at a grid-10 shell's 66 LOBPCG columns)."""
    E, threeN, k = ye.shape
    N = threeN // 3
    flat = ye.reshape(E * N, 3 * k)
    if ops.gather_idx is not None and ye.is_cuda:
        out = gather_sum(flat, ops.gather_idx)
    else:
        out = torch.zeros(ops.num_vertices, 3 * k, dtype=ye.dtype, device=ye.device)
        out.index_add_(0, ops.tets.reshape(-1), flat)
    return out.reshape(ops.num_vertices * 3, k)


def k_matvec(ops: ElementOps, x: torch.Tensor, mu, lam) -> torch.Tensor:
    """K @ X for X (3V, k): two batched matmuls + gather-sum."""
    count("fem.k_apply.calls")
    count("fem.k_apply.cols", x.shape[1])
    with span("diffsound.fem.k_apply"):
        xe = _gather(ops, x)
        ye = mu * torch.bmm(ops.k_mu, xe) + lam * torch.bmm(ops.k_lam, xe)
        return _scatter(ops, ye)


@dataclass(frozen=True)
class FrozenStiffness:
    """Material-combined element stiffness mu * k_mu + lam * k_lam.

    K is linear in (mu, lambda); inside an eigensolve the material is fixed,
    so the combined (E, 3N, 3N) blocks are formed once per solve and each
    matvec does one bmm instead of two."""

    ke: torch.Tensor


def freeze_stiffness(ops: ElementOps, mu, lam) -> FrozenStiffness:
    return FrozenStiffness(ke=mu * ops.k_mu + lam * ops.k_lam)


def k_matvec_frozen(ops: ElementOps, fz: FrozenStiffness, x: torch.Tensor) -> torch.Tensor:
    """K @ X with a pre-frozen material (see FrozenStiffness)."""
    count("fem.k_apply.calls")
    count("fem.k_apply.cols", x.shape[1])
    with span("diffsound.fem.k_apply"):
        return _scatter(ops, torch.bmm(fz.ke, _gather(ops, x)))


def m_matvec(ops: ElementOps, x: torch.Tensor, density) -> torch.Tensor:
    """M @ X for X (3V, k)."""
    k = x.shape[1]
    count("fem.m_apply.calls")
    count("fem.m_apply.cols", k)
    E, N = ops.tets.shape
    with span("diffsound.fem.m_apply"):
        xe = x.reshape(ops.num_vertices, 3, k)[ops.tets].reshape(E, N, 3 * k)
        ye = torch.matmul(ops.mref, xe)  # (E, N, 3k)
        ye = ye * (density * ops.mass_scale)[:, None, None]
        return _scatter(ops, ye.reshape(E, 3 * N, k))


def k_diag(ops: ElementOps, mu, lam) -> torch.Tensor:
    """diag(K) (3V,) — Jacobi preconditioner / pencil scaling source."""
    ke_diag = mu * ops.k_mu.diagonal(dim1=1, dim2=2) + lam * ops.k_lam.diagonal(dim1=1, dim2=2)
    return _scatter(ops, ke_diag[:, :, None])[:, 0]


def m_diag(ops: ElementOps, density) -> torch.Tensor:
    """diag(M) (3V,)."""
    d = ops.mref.diagonal()  # (N,)
    de = d[None, :] * (density * ops.mass_scale)[:, None]  # (E, N)
    E, N = ops.tets.shape
    de3 = de[:, :, None].expand(E, N, 3)
    return _scatter(ops, de3.reshape(E, 3 * N, 1))[:, 0]


def m_lumped(ops: ElementOps, density) -> torch.Tensor:
    """Row-sum lumped mass (3V,): positive, for scaling."""
    rs = ops.mref.sum(dim=1)  # (N,)
    de = rs[None, :] * (density * ops.mass_scale)[:, None]
    E, N = ops.tets.shape
    de3 = de[:, :, None].expand(E, N, 3)
    return _scatter(ops, de3.reshape(E, 3 * N, 1))[:, 0]


# ---------------------------------------------------------------------------
# Host-side sparse assembly (ARPACK cold solve + tests)
# ---------------------------------------------------------------------------


def assemble_scipy(ops: ElementOps, mu: float, lam: float, density: float):
    """Assemble (K, M) as scipy CSR from the element blocks (host only)."""
    import scipy.sparse as sp

    tets = ops.tets.cpu().numpy()
    E, N = tets.shape
    k_mu = ops.k_mu.detach().cpu().to(torch.float64).numpy()
    k_lam = ops.k_lam.detach().cpu().to(torch.float64).numpy()
    ke = mu * k_mu + lam * k_lam
    dof = (tets[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(E, 3 * N)
    rows = np.repeat(dof, 3 * N, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 3 * N)).reshape(-1)
    nv = ops.num_vertices
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(3 * nv, 3 * nv)).tocsr()

    mref = ops.mref.detach().cpu().to(torch.float64).numpy()
    scale = density * ops.mass_scale.detach().cpu().to(torch.float64).numpy()
    me = np.einsum("ab,ij->aibj", mref, np.eye(3)).reshape(3 * N, 3 * N)
    me_all = scale[:, None, None] * me[None]
    M = sp.coo_matrix(
        (me_all.reshape(-1), (rows, cols)), shape=(3 * nv, 3 * nv)
    ).tocsr()
    K.sum_duplicates()
    M.sum_duplicates()
    return K, M


class FEMOperators:
    """A TetMesh bound to its element operators on `device` (default CUDA;
    dtype defaults to `default_dtype(device)`)."""

    def __init__(self, mesh, dtype=None, device="cuda"):
        from .. import default_dtype, resolve_device

        self.device = resolve_device(device)
        self.mesh = mesh
        self.order = mesh.order
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.ops = build_element_ops(
            torch.as_tensor(mesh.vertices, device=self.device), mesh.tets, mesh.order,
            dtype=self.dtype,
        )

    def k_matvec(self, x, mu, lam):
        return k_matvec(self.ops, x, mu, lam)

    def m_matvec(self, x, density):
        return m_matvec(self.ops, x, density)

    @property
    def num_dof(self):
        return 3 * self.ops.num_vertices


# ---------------------------------------------------------------------------
# General stress path (arbitrary / learned materials)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeformOps:
    """Per-(element, gauss) world-space shape gradients B and integration
    weights w: the matrix-free K action through an arbitrary stress function
    sigma(F), at per-gauss-point cost (the factored (k_mu, k_lam) blocks
    hard-code isotropic linear elasticity; this path takes any
    differentiable stress model, `material.TinyNN` in particular)."""

    tets: torch.Tensor  # (E, N) int64
    B: torch.Tensor  # (E, G, N, 3)
    w: torch.Tensor  # (E, G) gauss weight x |det A| (masked tets: 0)
    num_vertices: int
    gather_idx: torch.Tensor  # (V, D), as ElementOps.gather_idx


def build_deform_ops(vertices: torch.Tensor, tets, order: int,
                     dtype: Optional[torch.dtype] = None,
                     tet_mask: Optional[torch.Tensor] = None) -> DeformOps:
    order = int(order)
    device = vertices.device
    dtype = vertices.dtype if dtype is None else dtype
    tets_t = torch.as_tensor(np.asarray(tets.cpu() if torch.is_tensor(tets) else tets, np.int64),
                             device=device)
    vertices = vertices.to(dtype)
    _, wts = gauss_tet_quadrature(order + 2)
    wts = torch.as_tensor(wts, dtype=dtype, device=device)
    dndx_ref = torch.as_tensor(shape_grad_table(order), dtype=dtype, device=device)  # (G, N, 3)
    c = tets_t[:, list(CORNER_NODES[order])]
    v1, v2, v3, v4 = (vertices[c[:, i]] for i in range(4))
    A = torch.stack([v1 - v4, v2 - v4, v3 - v4], dim=-1)
    detA, A_inv = inv3x3(A, safe=True)
    B = torch.einsum("gak,ekj->egaj", dndx_ref, A_inv)  # (E, G, N, 3)
    w = wts[None, :] * detA.abs()[:, None]
    if tet_mask is not None:
        w = w * tet_mask.to(dtype)[:, None]
    nv = int(vertices.shape[0])
    gidx = torch.as_tensor(build_gather_transpose(tets_t.cpu().numpy(), nv), dtype=torch.int64,
                           device=device)
    return DeformOps(tets=tets_t, B=B, w=w, num_vertices=nv, gather_idx=gidx)


def deformation_gradients(dops: DeformOps, x: torch.Tensor) -> torch.Tensor:
    """x (3V, k) modal displacements -> F (E, G, k, 3, 3) per gauss point:
    F_ij = sum_a u[a, i] B[a, j]."""
    k = x.shape[-1]
    xe = x.reshape(dops.num_vertices, 3, k)[dops.tets]  # (E, N, 3, k)
    return torch.einsum("eaik,egaj->egkij", xe, dops.B)


def k_matvec_stress(dops: DeformOps, stress_fn, x: torch.Tensor) -> torch.Tensor:
    """K @ X through an arbitrary stress function: F -> sigma(F) -> nodal
    forces, summed over the elements of each vertex.  stress_fn maps
    (..., 3, 3) -> (..., 3, 3); with isotropic linear elasticity this is
    `k_matvec` exactly."""
    F = deformation_gradients(dops, x)  # (E, G, k, 3, 3)
    sw = stress_fn(F) * dops.w[:, :, None, None, None]
    ye = torch.einsum("egkij,egaj->eaik", sw, dops.B)  # (E, N, 3, k)
    E_, N_ = dops.tets.shape
    return _scatter(dops, ye.reshape(E_, 3 * N_, -1))
