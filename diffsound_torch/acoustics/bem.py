"""Helmholtz boundary-element acoustic transfer.

Counterpart of `diffsound_tpu/acoustics/bem.py`: given a vibrating surface
mesh and the normal velocity of a mode (the Neumann data), solve the
exterior Helmholtz boundary equation for the surface pressure and evaluate
the radiated potential at far-field points.

Direct collocation with piecewise-constant (DP0) elements on triangles.
With the free-space Green's function G(x, y) = e^{ikr} / (4 pi r):

    (-1/2) phi_i + sum_j K_ij phi_j = sum_j V_ij psi_j      (boundary)
    p(x) = sum_j [ dG/dn_y (x, c_j) A_j phi_j - G(x, c_j) A_j psi_j ]

V (single layer) and K (double layer) use centroid quadrature with an
equivalent-disk regularization of the singular self term (the double-layer
self term vanishes on planar panels).  The matrices are dense complex
(F x F) tensors on the device, complex64 from float32 geometry and
complex128 from float64, and the system is solved directly
(`torch.linalg.solve`).

k = omega / c = 2 pi f / 343.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import default_dtype, resolve_device

SPEED_OF_SOUND = 343.0
AIR_DENSITY = 1.225


def _triangle_geometry(verts: np.ndarray, faces: np.ndarray):
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    centers = (a + b + c) / 3.0
    n = np.cross(b - a, c - a)
    areas = 0.5 * np.linalg.norm(n, axis=1)
    normals = n / (2.0 * areas[:, None] + 1e-300)
    return centers, areas, normals


class BEMModel:
    """Exterior Helmholtz solve on a triangle surface mesh:
    `boundary_equation_solve(neumann)` -> surface pressure coefficients;
    `potential_solve(points)` -> radiated pressure at exterior points.
    dtype is the real dtype of the geometry (default: `default_dtype`)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, frequency: float,
                 device="cuda", dtype=None):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.k = 2.0 * np.pi * float(frequency) / SPEED_OF_SOUND
        self.centers, self.areas, self.normals = _triangle_geometry(self.vertices, self.faces)
        self._phi = None

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # -- kernels ------------------------------------------------------------

    def _green(self, x, y):
        """G(x, y) for x (..., 3), y (F, 3) -> complex (..., F)."""
        r = torch.linalg.vector_norm(x[..., None, :] - y[None, :, :], dim=-1)
        r = torch.clamp(r, min=1e-12)
        return torch.exp(1j * self.k * r) / (4.0 * math.pi * r)

    def _green_dn(self, x, y, n_y):
        """dG/dn_y (x, y) -> complex (..., F)."""
        d = x[..., None, :] - y[None, :, :]  # (..., F, 3)
        r = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-12)
        # dG/dr * dr/dn_y ; dr/dn_y = -(d . n) / r
        dGdr = torch.exp(1j * self.k * r) * (1j * self.k * r - 1.0) / (4.0 * math.pi * r**2)
        cos = -(d * n_y[None, :, :]).sum(dim=-1) / r
        return dGdr * cos

    def _matrices(self):
        c, A, n = self._t(self.centers), self._t(self.areas), self._t(self.normals)
        V = self._green(c, c) * A[None, :]
        Kd = self._green_dn(c, c, n) * A[None, :]
        # singular self terms: equivalent-disk single layer, zero double layer
        R = torch.sqrt(A / math.pi)
        v_self = R / 2.0  # int_disk 1/(4 pi r) dA = R / 2
        eye = torch.eye(len(self.areas), dtype=torch.bool, device=self.device)
        V = torch.where(eye, v_self.to(V.dtype)[None, :], V)
        Kd = torch.where(eye, torch.zeros((), dtype=Kd.dtype, device=self.device), Kd)
        return V, Kd

    # -- API ----------------------------------------------------------------

    def boundary_equation_solve(self, neumann):
        """neumann: per-face dp/dn (F,) (for a mode with normal surface
        acceleration a_n, dp/dn = -rho * a_n).  Returns the surface pressure
        phi (F,) complex on the device."""
        V, Kd = self._matrices()
        psi = torch.as_tensor(np.asarray(neumann), device=self.device).to(V.dtype)
        F = V.shape[0]
        lhs = -0.5 * torch.eye(F, dtype=V.dtype, device=self.device) + Kd
        self._phi = torch.linalg.solve(lhs, V @ psi)
        self._psi = psi
        return self._phi

    def potential_solve(self, points):
        """Radiated potential at exterior points (P, 3) -> complex (P,)."""
        if self._phi is None:
            raise RuntimeError("call boundary_equation_solve first")
        x = self._t(points)
        A, n, c = self._t(self.areas), self._t(self.normals), self._t(self.centers)
        Kx = self._green_dn(x, c, n) * A[None, :]
        Vx = self._green(x, c) * A[None, :]
        return Kx @ self._phi - Vx @ self._psi

    def mode_neumann_from_displacement(self, vert_displacement: np.ndarray, omega: float):
        """Neumann data for a harmonic mode shape: per-face normal
        acceleration -> dp/dn = rho_air * omega^2 * (u . n) (host numpy)."""
        u_face = np.asarray(vert_displacement)[self.faces].mean(axis=1)  # (F, 3)
        un = np.einsum("fd,fd->f", u_face, self.normals)
        return AIR_DENSITY * omega**2 * un
