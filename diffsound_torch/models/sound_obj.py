"""DiffSoundObject: the central differentiable modal model.

Counterpart of `diffsound_tpu/models/sound_obj.py`.  Matrix-free element
operators on the device, a host ARPACK cold solve per material pair, warm
LOBPCG refreshes on the device, and Rayleigh-corrected differentiable
eigenvalues.

The warm eigensolve operates on the diagonally-scaled pencil

    (D K D) y = lambda (D M D) y,   D = diag(K)^(-1/2),  x = D y

which leaves eigenvalues untouched, keeps the Gram matrices well-scaled,
and turns Jacobi preconditioning into the identity.  Material constants are
density-normalized (E/rho, unit density) throughout; eigenvalues are
invariant.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import default_dtype, resolve_device
from ..fem import assembly
from ..fem.material import Material, lame_params
from ..fem.mesh import TetMesh
from ..solvers.arpack import eigsh_shift_invert
from ..solvers.diff_eigs import rayleigh_corrected_eigenvalues, undamped_frequencies
from ..solvers.lobpcg import lobpcg
from .material_model import MaterialBins


@dataclass
class EigenState:
    """Detached eigensolver output (k = mode_num + 6, rigid modes first)."""

    eigenvalues: torch.Tensor  # (k,)
    eigenvectors: torch.Tensor  # (3V, k), M-orthonormal
    iterations: int
    residual: torch.Tensor  # (k,)


@dataclass
class ModalCache:
    """Per-refresh quadratic forms for fixed-geometry material inference.

    K is linear in the Lame scalars (K = mu K_mu + lambda K_lam), so the
    Rayleigh correction diag(U^T K U) - lam diag(U^T M U) collapses to
        lam~ = lam + mu q_mu + lambda q_lam - lam q_m
    with (q_mu, q_lam, q_m) computed once per eigensolve refresh; the
    per-step corrected eigenvalues (and their exact material gradients) are
    then O(mode_num) elementwise work."""

    eigenvalues: torch.Tensor  # (k,) detached
    q_mu: torch.Tensor  # (k,) diag(U^T K_mu U)
    q_lam: torch.Tensor  # (k,) diag(U^T K_lam U)
    q_m: torch.Tensor  # (k,) diag(U^T M U)


class DiffSoundObject:
    """Differentiable modal sound model bound to one tet mesh.

    task: "material" (trainable E + nu), "mat_baseline" (trainable E only),
    or "gt" (fixed table material).  device defaults to "cuda" and raises
    without a GPU; dtype defaults to f32 on CUDA, f64 on the CPU."""

    def __init__(
        self,
        mesh: TetMesh = None,
        mode_num: int = 16,
        order: int = 1,
        mat=None,
        task: str = "gt",
        mesh_path: str = None,
        dtype: Optional[torch.dtype] = None,
        extra_modes: int = 6,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        if mesh is None:
            if mesh_path is None:
                raise ValueError("need mesh or mesh_path")
            if mesh_path.endswith(".obj"):
                mesh = TetMesh.from_triangle_mesh(mesh_path)
            else:
                mesh = TetMesh.from_file(mesh_path)
        if mesh.order != order:
            if mesh.order != 1:
                raise ValueError("mesh order mismatch")
            mesh = mesh.to_high_order(order)
        self.mesh = mesh
        self.order = order
        self.mode_num = mode_num
        self.extra_modes = extra_modes  # rigid-body modes solved then dropped
        self.task = task
        self.mat = Material.of(mat) if mat is not None else Material.of((2700, 7.2e10, 0.19, 6, 1e-7))
        self.bins = MaterialBins(self.mat, learn_poisson=(task == "material"))

        self.ops = assembly.build_element_ops(
            torch.as_tensor(mesh.vertices, device=self.device), mesh.tets, order,
            dtype=self.dtype,
        )
        self.num_dof = 3 * self.ops.num_vertices
        self._host_ops = None

    def host_ops(self) -> assembly.ElementOps:
        """f64 element ops on the host CPU, for the sparse ARPACK path."""
        if self._host_ops is None:
            if self.device.type == "cpu" and self.dtype == torch.float64:
                self._host_ops = self.ops
            else:
                self._host_ops = assembly.build_element_ops(
                    torch.as_tensor(self.mesh.vertices, dtype=torch.float64),
                    self.mesh.tets, self.order, dtype=torch.float64,
                )
        return self._host_ops

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int = 0, pretrain: bool = True):
        if self.task == "gt":
            return {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.bins.init_params(gen, device=self.device)
        if pretrain:
            params = self.bins.pretrain(params)
        return params

    def material_lame(self, params):
        """Density-normalized (mu, lambda) from params (or the fixed table
        material for the gt task)."""
        if self.task == "gt" or not params:
            return lame_params(self.mat.youngs / self.mat.density, self.mat.poisson)
        mu, lam = self.bins.lame(params, density_normalized=True)
        return mu.to(self.dtype), lam.to(self.dtype)

    def material_lame_floats(self, params):
        """material_lame as two Python floats (detached)."""
        with torch.no_grad():
            mu, lam = self.material_lame(params)
        return float(mu), float(lam)

    # -- eigensolve (detached) ---------------------------------------------

    def _k_fn(self, mu, lam):
        return lambda x: assembly.k_matvec(self.ops, x, mu, lam)

    def _m_fn(self):
        return lambda x: assembly.m_matvec(self.ops, x, 1.0)

    def _lobpcg_solve(self, mu: float, lam: float, x0: torch.Tensor) -> EigenState:
        with torch.no_grad():
            d = assembly.k_diag(self.ops, mu, lam)
            dsc = torch.rsqrt(torch.clamp(d, min=torch.finfo(self.dtype).tiny))[:, None]
            # freeze the material into the element blocks once per solve
            fz = assembly.freeze_stiffness(self.ops, mu, lam)
            a_fn = lambda y: dsc * assembly.k_matvec_frozen(self.ops, fz, dsc * y)
            b_fn = lambda y: dsc * assembly.m_matvec(self.ops, dsc * y, 1.0)
            f32 = self.dtype == torch.float32
            # f32: tol just above the matvec noise floor, Ritz error is
            # O(residual^2); warm refreshes carry/rotate A S, B S
            # (reuse_products).  f64: tol just above the pencil's residual
            # noise floor, recompute body.
            res = lobpcg(
                a_fn, b_fn, x0.to(self.dtype) / dsc,
                max_iters=40 if f32 else 300,
                tol=1e-3 if f32 else 1e-8,
                reuse_products=f32,
            )
            return EigenState(
                res.eigenvalues, dsc * res.eigenvectors, res.iterations,
                res.residual_norms,
            )

    def _arpack_solve(self, mu: float, lam: float, sigma: float) -> EigenState:
        k = self.mode_num + self.extra_modes
        K, M = assembly.assemble_scipy(self.host_ops(), mu, lam, 1.0)
        vals, vecs = eigsh_shift_invert(K, M, k=k, sigma=sigma)
        return EigenState(
            torch.as_tensor(vals, dtype=self.dtype, device=self.device),
            torch.as_tensor(vecs, dtype=self.dtype, device=self.device),
            0,
            torch.zeros(k, dtype=self.dtype, device=self.device),
        )

    def eigen_decomposition(self, params=None, sigma: float = 20000.0) -> EigenState:
        """Solve the generalized pencil for the mode_num + extra_modes
        smallest eigenpairs, cold: host ARPACK shift-invert (LOBPCG with
        Jacobi preconditioning converges too slowly from random vectors).
        Warm solves go through `refresh` and `eigen_decomposition_at_lame`."""
        mu, lam = self.material_lame_floats(params)
        return self._arpack_solve(mu, lam, sigma)

    def eigen_decomposition_at_lame(
        self, mu: float, lam: float, prev: Optional[EigenState] = None,
        sigma: float = 20000.0,
    ) -> EigenState:
        """eigen_decomposition at explicit density-normalized Lame values
        (the modal-Newton fit iterates over materials without bin params):
        warm LOBPCG when `prev` is given, host ARPACK cold."""
        if prev is not None:
            return self._lobpcg_solve(float(mu), float(lam), prev.eigenvectors)
        return self._arpack_solve(float(mu), float(lam), sigma)

    # -- per-refresh quadratic-form cache ----------------------------------

    def modal_cache(self, eig: EigenState) -> ModalCache:
        """Quadratic forms for the cached differentiable-eigenvalue path
        (fixed geometry only)."""
        with torch.no_grad():
            U = eig.eigenvectors
            ku_mu = assembly.k_matvec(self.ops, U, 1.0, 0.0)
            ku_lam = assembly.k_matvec(self.ops, U, 0.0, 1.0)
            mu_ = assembly.m_matvec(self.ops, U, 1.0)
            return ModalCache(
                eigenvalues=eig.eigenvalues.detach(),
                q_mu=(U * ku_mu).sum(dim=0),
                q_lam=(U * ku_lam).sum(dim=0),
                q_m=(U * mu_).sum(dim=0),
            )

    def refresh(self, params, prev: EigenState):
        """Warm LOBPCG refresh + modal cache (the training loop's refresh)."""
        mu, lam = self.material_lame_floats(params)
        eig = self._lobpcg_solve(mu, lam, prev.eigenvectors)
        return eig, self.modal_cache(eig)

    def corrected_eigenvalues_cached(self, params, cache: ModalCache):
        """lam~ from the cache — equal to the matvec path for isotropic
        material (K linear in mu, lambda), at O(k) cost."""
        mu, lam = self.material_lame(params)
        ev = cache.eigenvalues
        return ev + mu * cache.q_mu + lam * cache.q_lam - ev * cache.q_m

    def get_undamped_freqs_cached(self, params, cache: ModalCache):
        lams = self.corrected_eigenvalues_cached(params, cache)[self.extra_modes :]
        return undamped_frequencies(lams)

    # -- differentiable eigenvalues / frequencies --------------------------

    def corrected_eigenvalues(self, params, eig: EigenState):
        """All k corrected eigenvalues (rigid modes included), differentiable
        w.r.t. params."""
        mu, lam = self.material_lame(params)
        return rayleigh_corrected_eigenvalues(
            self._k_fn(mu, lam), self._m_fn(), eig.eigenvalues, eig.eigenvectors
        )

    def get_vals(self, params, eig: EigenState):
        """Corrected non-rigid eigenvalues (mode_num,)."""
        return self.corrected_eigenvalues(params, eig)[self.extra_modes :]

    def get_undamped_freqs(self, params, eig: EigenState):
        """Non-rigid undamped frequencies (mode_num,) in Hz."""
        return undamped_frequencies(self.get_vals(params, eig))


def build_model(
    mesh_path: str = None,
    mesh: TetMesh = None,
    mode_num: int = 16,
    order: int = 1,
    mat=None,
    task: str = "gt",
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> DiffSoundObject:
    """Reference-shaped constructor."""
    if task not in ("material", "mat_baseline", "gt"):
        raise ValueError(f"task {task} not defined")
    return DiffSoundObject(
        mesh=mesh,
        mesh_path=mesh_path,
        mode_num=mode_num,
        order=order,
        mat=mat,
        task=task,
        dtype=dtype,
        device=device,
    )
