"""Element-sharded FEM operators.

Counterpart of `diffsound_tpu/parallel/ops.py`.  The element arrays (tets,
k_mu, k_lam, mass_scale) are padded with zero-block tets (at vertex 0) to a
multiple of ep and split over the ep ranks on their leading dimension.  A
K @ X is `fem.assembly.k_matvec` on the shard's element arrays: it gathers
the replicated node block, runs the local float32 (or float64) block
products and sums each vertex's rows of the shard without atomics (on the
card through the shard's own gather transpose, `build_gather_transpose` and
`gather_sum`; on the CPU by the sequential index_add_).  Then one
all-reduce over the ep group sums the shards' node blocks, the nodes they
share included.  The collective is not
differentiable: callers run these under `torch.no_grad()`.

Material scalars may be per column: `k_matvec(x, mu, lam)` with mu and lam
of shape (c,) for x (3V, c) applies each column's own material, which is
how the multi-pair trainer applies K for all pairs in one product per block
type.
"""

from __future__ import annotations

import torch

from ..fem import assembly
from ..fem.assembly import ElementOps, build_gather_transpose
from .mesh import DeviceMesh


def pad_element_ops(ops: ElementOps, multiple: int) -> ElementOps:
    """Pad the element dimension to a multiple with zero-block tets at
    vertex 0 (they add exact zeros to K and M)."""
    pad = (-ops.num_tets) % multiple
    if pad == 0:
        return ops
    pz = lambda a: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return ElementOps(  # the shards build their own gather transposes
        tets=pz(ops.tets), k_mu=pz(ops.k_mu), k_lam=pz(ops.k_lam),
        mass_scale=pz(ops.mass_scale), mref=ops.mref, num_vertices=ops.num_vertices,
    )


def shard_element_ops(ops: ElementOps, mesh: DeviceMesh) -> ElementOps:
    """This ep rank's slice of the padded element arrays on `mesh.device`,
    with its own gather transpose (indices into the slice's rows)."""
    ops = pad_element_ops(ops, mesh.ep)
    chunk = ops.num_tets // mesh.ep
    sl = slice(mesh.ep_rank * chunk, (mesh.ep_rank + 1) * chunk)
    dev = mesh.device
    tets = ops.tets[sl]
    gidx = build_gather_transpose(tets.cpu().numpy(), ops.num_vertices)
    return ElementOps(
        tets=tets.to(dev), k_mu=ops.k_mu[sl].to(dev), k_lam=ops.k_lam[sl].to(dev),
        mass_scale=ops.mass_scale[sl].to(dev), mref=ops.mref.to(dev),
        num_vertices=ops.num_vertices,
        gather_idx=torch.as_tensor(gidx, dtype=torch.int64, device=dev),
    )


class ShardedFEM:
    """Matrix-free K @ X, M @ X and diag(K) with elements sharded over the
    mesh's ep ranks; every result is the whole mesh's, on every rank."""

    def __init__(self, ops: ElementOps, mesh: DeviceMesh):
        self.mesh = mesh
        self.ops = shard_element_ops(ops, mesh)
        self.num_vertices = ops.num_vertices

    def k_matvec(self, x: torch.Tensor, mu, lam) -> torch.Tensor:
        """K @ X for X (3V, c); mu, lam scalars or (c,) per column."""
        return self.mesh.ep_sum(assembly.k_matvec(self.ops, x, mu, lam))

    def m_matvec(self, x: torch.Tensor, density=1.0) -> torch.Tensor:
        """M @ X for X (3V, c)."""
        return self.mesh.ep_sum(assembly.m_matvec(self.ops, x, density))

    def k_diag(self, mu, lam) -> torch.Tensor:
        """diag(K): (3V,) for scalar mu, lam; (3V, c) for (c,) materials."""
        per_col = torch.is_tensor(mu) and mu.dim() == 1
        dk_mu = self.ops.k_mu.diagonal(dim1=1, dim2=2)[:, :, None]
        dk_lam = self.ops.k_lam.diagonal(dim1=1, dim2=2)[:, :, None]
        d = self.mesh.ep_sum(assembly._scatter(self.ops, mu * dk_mu + lam * dk_lam))
        return d if per_col else d[:, 0]

    def quadratic_forms(self, U: torch.Tensor) -> torch.Tensor:
        """(3, c): diag(U^T K_mu U), diag(U^T K_lam U), diag(U^T M U) of the
        columns of U (3V, c), at unit density.  The forms are linear in each
        shard's node sums, so only the (3, c) result crosses the ep group."""
        q = torch.stack([(U * assembly.k_matvec(self.ops, U, 1.0, 0.0)).sum(0),
                         (U * assembly.k_matvec(self.ops, U, 0.0, 1.0)).sum(0),
                         (U * assembly.m_matvec(self.ops, U, 1.0)).sum(0)])
        return self.mesh.ep_sum(q)
