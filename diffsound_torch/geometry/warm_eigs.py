"""Device-resident warm-started eigensolver for the shape tasks.

Counterpart of `diffsound_tpu/geometry/warm_eigs.py::WarmShapeEigensolver`.
The reference re-runs host ARPACK from scratch at every iteration of the
thickness, morphing and geometry loops; this keeps the eigenvector basis on
the device between iterations instead:

  * the basis lives in GLOBAL background-grid slot coordinates
    ((V + Eg + 1) x 3 x k, last row = scatter dump), the one indexing that
    is stable across remeshes: marching-tets compaction changes the vertex
    count every iteration, but old and new compact meshes index the same
    global slots, so the basis maps across a remesh by gather (new
    keep_idx) and scatter (keep_idx with the pad rows redirected to the
    dump row, so that no two rows write one slot);
  * gather, diagonally scaled LOBPCG over the bucket-padded element
    operators, and scatter back run on the device; the basis never crosses
    to the host;
  * pad rows need no shifting: the padded operators never read or write
    them, and `lobpcg(row_mask=...)` keeps the solver's random vectors zero
    there;
  * cold starts (first iteration, low slot overlap after a topology jump, a
    diverged residual, an explicit re-anchor or the `reanchor_every`
    cadence) run host ARPACK for the k modes and the guard columns and push
    its basis once;
  * `map_only` maps the stored basis across a remesh with no solve.

The JAX package's per-bucket jit caches become plain calls.  The storage is
float32 whatever the working dtype, as the JAX package's is.  The host
anchors solve for the guard columns too (the JAX package seeds them with
noise), so the warm output is held against host ARPACK, not against JAX's
warm output.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..fem import assembly
from ..solvers.lobpcg import lobpcg


def padded_gather_transpose(comp) -> np.ndarray:
    """The scatter->gather transpose of a bucket-padded compact mesh."""
    return assembly.padded_gather_transpose(comp["tets"], comp["num_tets"], len(comp["keep_idx"]))


class WarmShapeEigensolver:
    def __init__(
        self,
        num_global_slots: int,
        k: int,
        dtype=torch.float32,
        device="cuda",
        reanchor_every: int = 0,
        max_iters: int = 240,
    ):
        """num_global_slots: V + Eg of the background grid (rows of
        MarchingOutput.all_verts).  k: modes incl. the rigid block.
        dtype: the solve's working dtype (the stored basis is float32).
        reanchor_every: force a host cold solve after that many warm solves
        in a row (0: never).  max_iters: LOBPCG iterations of a warm round
        (two rounds before a host re-anchor)."""
        self.num_global_slots = num_global_slots
        self.k = k
        # guard columns absorb the slowly separating directions just above
        # the wanted block; they ride along and never gate convergence
        self.guards = 8
        self.kg = k + self.guards
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_iters = max_iters
        # Ritz-value error is O(residual^2): a 1e-2 residual basis gives
        # 1.5e-4 relative eigenvalue error on the grid-64 shell; f64
        # converges comfortably at 1e-4
        self.tol = 3e-3 if dtype == torch.float32 else 1e-4
        # the largest max relative residual at which a warm result is
        # accepted (above it: one more round, then a host re-anchor).  The
        # eigenvalues' error from host ARPACK grows with the residual: on
        # the H100 the geometry task's grid-32 solves read 3.1e-4 at 3.0e-3,
        # 1.1e-3 at 1.1e-2 and 2.4e-3 at 1.6e-2, the thickness task's
        # grid-64 solve 1.9e-4 at 4.7e-3; 5e-3 keeps them within 1e-3
        self.accept_resid = 5e-3
        # minimum fraction of the new mesh's vertices already in the basis
        self.min_overlap = 0.6
        self.reanchor_every = reanchor_every

        self.U_global = None  # device (slots + 1, 3, kg); row slots = dump
        self.seen = np.zeros(num_global_slots, bool)
        # host copy of each seen slot's last position: the nearest-neighbour
        # source for brand-new slots (newly crossing edges), whose zero rows
        # would otherwise stall the refresh
        self.slot_pos = np.full((num_global_slots, 3), np.nan, np.float64)
        self.warm_count = 0  # warm solves since the last host anchor
        self.total_warm = 0
        self.total_cold = 0
        self.total_mapped = 0
        self.last_vals = None  # (k,) numpy from the last true solve
        self.last_iterations = 0
        self.last_resid = 0.0  # max residual of the last warm solve
        self.last_mode = "none"
        self._anchor_requested = False

    # -- host <-> device basis management -----------------------------------

    def _ensure_storage(self):
        if self.U_global is None:
            self.U_global = torch.zeros(
                (self.num_global_slots + 1, 3, self.kg), dtype=torch.float32, device=self.device
            )

    def _keep_store(self, comp) -> torch.Tensor:
        """keep_idx with pad rows redirected to the dump slot."""
        keep = np.asarray(comp["keep_idx"]).copy()
        keep[comp["num_verts"]:] = self.num_global_slots
        return torch.as_tensor(keep, device=self.device)

    def store_host(self, comp, U):
        """Push a host basis of k + guards modes (cold solves) into the device
        storage."""
        self._ensure_storage()
        vpad = len(comp["keep_idx"])
        U = torch.as_tensor(np.asarray(U), dtype=torch.float32, device=self.device)
        self.U_global[self._keep_store(comp)] = U.reshape(vpad, 3, self.kg)
        self.seen[np.asarray(comp["keep_idx"])[: comp["num_verts"]]] = True

    def mark_positions(self, out, comp):
        """Record the current positions of this mesh's slots."""
        keep_nv = np.asarray(comp["keep_idx"])[: comp["num_verts"]]
        self.slot_pos[keep_nv] = self._positions(out, keep_nv)

    @staticmethod
    def _positions(out, rows):
        with torch.no_grad():
            idx = torch.as_tensor(rows, device=out.all_verts.device)
            return out.all_verts[idx].to(torch.float64).cpu().numpy()

    def _fill_new_slots(self, out, comp):
        """Copy the nearest seen slot's basis row into each unseen slot of
        the new mesh (a device row copy driven by a host KD query)."""
        nv = comp["num_verts"]
        keep = np.asarray(comp["keep_idx"])[:nv]
        new_mask = ~self.seen[keep]
        if not new_mask.any():
            return
        seen_ids = np.flatnonzero(self.seen)
        if len(seen_ids) == 0:
            return
        from scipy.spatial import cKDTree

        tree = cKDTree(self.slot_pos[seen_ids])
        _, nn = tree.query(self._positions(out, keep[new_mask]), k=1)
        src = torch.as_tensor(seen_ids[nn], device=self.device)
        dst = torch.as_tensor(keep[new_mask], device=self.device)
        self.U_global[dst] = self.U_global[src]

    def overlap(self, comp) -> float:
        nv = comp["num_verts"]
        keep = np.asarray(comp["keep_idx"])[:nv]
        return float(self.seen[keep].mean()) if nv else 0.0

    # -- gather + solve + scatter-back ----------------------------------------

    def _solve_once(self, args, reuse: bool):
        """One device round: gather the stored basis, solve the diagonally
        scaled pencil, scatter the result back into the storage."""
        keep_gather, keep_store, verts_c, tets_c, tet_mask, gidx, dof_mask, mu, lam = args
        vpad = keep_gather.shape[0]
        x0 = self.U_global[keep_gather].reshape(3 * vpad, self.kg).to(self.dtype)
        x0 = x0 * dof_mask[:, None]
        with torch.no_grad():
            ops = assembly.build_element_ops(
                verts_c, tets_c, 1, dtype=self.dtype, tet_mask=tet_mask, gather_idx=gidx
            )
            d = assembly.k_diag(ops, mu, lam)
            d = torch.where(dof_mask > 0, d, torch.ones_like(d))
            dsc = torch.rsqrt(torch.clamp(d, min=torch.finfo(self.dtype).tiny))
            fz = assembly.freeze_stiffness(ops, mu, lam)
        a_fn = lambda y: dsc[:, None] * assembly.k_matvec_frozen(ops, fz, dsc[:, None] * y)
        b_fn = lambda y: dsc[:, None] * assembly.m_matvec(ops, dsc[:, None] * y, 1.0)
        res = lobpcg(
            a_fn, b_fn, x0 / dsc[:, None], max_iters=self.max_iters, tol=self.tol,
            reuse_products=reuse, row_mask=dof_mask, num_wanted=self.k,
        )
        vecs = dsc[:, None] * res.eigenvectors  # (3vpad, kg)
        self.U_global[keep_store] = vecs.to(torch.float32).reshape(vpad, 3, self.kg)
        return (
            res.eigenvalues[: self.k],
            vecs[:, : self.k],
            res.iterations,
            res.residual_norms[: self.k].double().cpu().numpy(),
        )

    def _prep_args(self, out, comp, mu: float, lam: float):
        """Device inputs of `_solve_once`."""
        dev, dt = self.device, self.dtype
        vpad = len(comp["keep_idx"])
        keep = torch.as_tensor(np.asarray(comp["keep_idx"]), device=dev)
        with torch.no_grad():
            verts_c = out.all_verts[keep].to(dt)
        dof_mask = torch.zeros(3 * vpad, dtype=dt, device=dev)
        dof_mask[: 3 * comp["num_verts"]] = 1.0
        return (
            keep,
            self._keep_store(comp),
            verts_c,
            comp["tets"],
            torch.as_tensor(comp["tet_mask"], dtype=dt, device=dev),
            padded_gather_transpose(comp),
            dof_mask,
            torch.as_tensor(mu, dtype=dt, device=dev),
            torch.as_tensor(lam, dtype=dt, device=dev),
        )

    # -- public entry --------------------------------------------------------

    def _cold(self, out, comp, host_solve, mode, iterations=0):
        """A host solve of the k wanted modes and the guards, stored as the
        basis; the caller gets the first k.  Guard columns that start as
        converged modes, not noise: past a near-degenerate cluster at k (a
        sphere's) the wanted block's convergence rests on them, and noise
        guards left the joint task's first warm solve after each anchor
        short of the acceptance residual after two rounds."""
        vals, U = host_solve(self.kg)
        self.store_host(comp, U)
        vals, U = vals[: self.k], U[:, : self.k]
        self.mark_positions(out, comp)
        self.warm_count = 0
        self.total_cold += 1
        self.last_mode = mode
        self.last_iterations = int(iterations)
        self.last_resid = 0.0
        self._anchor_requested = False
        self.last_vals = np.asarray(vals, np.float64)
        return vals, U

    def map_only(self, out, comp):
        """Map the stored basis onto the current (remeshed) geometry without
        an eigensolve: (last_vals (k,), U (3*vpad, k) on the device), or None
        when no solved basis exists yet or the overlap is too low (the
        caller must solve).  The Ritz pass downstream is exact to first
        order in the drift since the last true solve, so a loop may solve on
        a cadence and map in between.  A mapped step runs no LOBPCG
        iteration and has no residual."""
        if self.U_global is None or self.last_vals is None:
            return None
        if self.overlap(comp) < self.min_overlap:
            return None
        self._fill_new_slots(out, comp)
        vpad = len(comp["keep_idx"])
        keep = torch.as_tensor(np.asarray(comp["keep_idx"]), device=self.device)
        U = self.U_global[keep].reshape(3 * vpad, self.kg)[:, : self.k]
        dof_mask = torch.zeros(3 * vpad, dtype=U.dtype, device=self.device)
        dof_mask[: 3 * comp["num_verts"]] = 1.0
        self.total_mapped += 1
        self.last_mode = "mapped"
        self.last_iterations = 0
        self.last_resid = 0.0
        return self.last_vals, U * dof_mask[:, None]

    def solve(
        self,
        out,
        comp,
        mu: float,
        lam: float,
        host_solve: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    ):
        """Eigensolve the compacted geometry: warm on the device when the
        stored basis covers it, host ARPACK otherwise.  Returns (vals (k,)
        numpy, U (3*vpad, k)): a device tensor after a warm solve, the host
        solver's numpy array after a cold one.  host_solve(n): the n lowest
        modes by a host solve, (vals (n,), U (3*vpad, n)); asked for k +
        guards."""
        if self.U_global is None or self._anchor_requested or (
                self.reanchor_every and self.warm_count >= self.reanchor_every) or (
                self.overlap(comp) < self.min_overlap):
            return self._cold(out, comp, host_solve, "cold")

        self._fill_new_slots(out, comp)
        args = self._prep_args(out, comp, mu, lam)
        vals, U, iters, resid = self._solve_once(args, reuse=True)
        if np.isfinite(resid).all() and float(resid.max()) > self.accept_resid:
            # geometry jumped past the budget: continue the same device solve
            # from its own output, products recomputed every iteration
            vals, U, iters2, resid = self._solve_once(args, reuse=False)
            iters = iters + iters2
        if not np.isfinite(resid).all() or float(resid.max()) > self.accept_resid:
            # genuinely diverged: host re-anchor
            return self._cold(out, comp, host_solve, "cold-escalated", iters)
        keep_nv = np.asarray(comp["keep_idx"])[: comp["num_verts"]]
        self.seen[keep_nv] = True
        self.slot_pos[keep_nv] = self._positions(out, keep_nv)
        self.warm_count += 1
        self.total_warm += 1
        self.last_mode = "warm"
        self.last_iterations = int(iters)
        self.last_resid = float(resid.max())
        self.last_vals = vals.double().cpu().numpy()
        return self.last_vals, U

    def request_anchor(self):
        """Force the next solve() to re-anchor on the host (for callers whose
        gradient-quality gate keeps tripping)."""
        self._anchor_requested = True
