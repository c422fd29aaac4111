"""Element-sharded FEM operators.

Counterpart of `diffsound_tpu/parallel/ops.py`.  The element arrays (tets,
k_mu, k_lam, mass_scale) are padded with zero-block tets (at vertex 0) to a
multiple of ep and split over the ep ranks on their leading dimension.  The
multi-pair trainer applies K and M to all pairs' blocks (B, 3V, k) at once
through `k_pairs` and `m_pairs`, which also take the solve's Jacobi
scaling: `fem.element_apply` on the shard's element arrays (the
hand-written kernel on the card, `fem.assembly`'s applies on the CPU),
then one all-reduce over the ep group sums the shards' node blocks, the
nodes they share included.  The collective is not differentiable: callers
run these under `torch.no_grad()`.
"""

from __future__ import annotations

import torch

from ..fem import assembly, element_apply
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
        self.plan = element_apply.apply_plan(self.ops) if self.ops.tets.is_cuda else None

    def k_pairs(self, x: torch.Tensor, mu, lam, scale=None) -> torch.Tensor:
        """diag(s_b) K(mu_b, lam_b) diag(s_b) x_b for every pair b of x
        (B, 3V, k); mu, lam (B,); scale s (B, 3V), or None for none."""
        return self.mesh.ep_sum(
            element_apply.k_pairs(self.ops, x.contiguous(), mu, lam, scale, self.plan))

    def m_pairs(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        """diag(s_b) M diag(s_b) x_b (unit density) for every pair b of x."""
        return self.mesh.ep_sum(element_apply.m_pairs(self.ops, x.contiguous(), scale, self.plan))

    def k_diag(self, mu, lam) -> torch.Tensor:
        """diag(K): (3V,) for scalar mu, lam; (3V, c) for (c,) materials."""
        per_col = torch.is_tensor(mu) and mu.dim() == 1
        dk_mu = self.ops.k_mu.diagonal(dim1=1, dim2=2)[:, :, None]
        dk_lam = self.ops.k_lam.diagonal(dim1=1, dim2=2)[:, :, None]
        d = self.mesh.ep_sum(assembly._scatter(self.ops, mu * dk_mu + lam * dk_lam))
        return d if per_col else d[:, 0]

    def quadratic_forms(self, U: torch.Tensor) -> torch.Tensor:
        """(3, B, k): diag(U_b^T K_mu U_b), diag(U_b^T K_lam U_b),
        diag(U_b^T M U_b) of every pair's block of U (B, 3V, k), at unit
        density.  The forms are linear in each shard's node sums, so only
        the (3, B, k) result crosses the ep group."""
        U = U.contiguous()
        one, zero = U.new_ones(U.shape[0]), U.new_zeros(U.shape[0])
        apply = lambda y: element_apply.k_pairs(self.ops, U, *y, plan=self.plan)
        q = torch.stack([(U * apply((one, zero))).sum(1), (U * apply((zero, one))).sum(1),
                         (U * element_apply.m_pairs(self.ops, U, plan=self.plan)).sum(1)])
        return self.mesh.ep_sum(q)
