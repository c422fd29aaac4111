"""Parity of the port's BEM (diffsound_torch.acoustics.bem) with the JAX
package on the same icosphere in float64 on the CPU: the dense V and K
matrices (rtol 1e-12), the surface solve and the radiated potential
(rtol 1e-10), and the Neumann data of a mode shape (exact); then the
analytic pulsating sphere and the far-field 1/r decay of tests/test_bem.py,
in complex128 and complex64."""

import numpy as np
import pytest
import torch

from diffsound_tpu.acoustics.bem import BEMModel as JBEM
from diffsound_torch.acoustics import BEMModel
from diffsound_torch.acoustics.bem import AIR_DENSITY, SPEED_OF_SOUND
from tests.test_geometry import icosphere

torch.set_num_threads(2)


def test_matrices_and_solve_match_jax():
    verts, faces = icosphere(2, radius=0.1)
    rng = np.random.default_rng(0)
    psi = rng.normal(size=len(faces)) + 1j * rng.normal(size=len(faces))
    pts = rng.normal(size=(5, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * rng.uniform(0.5, 3.0, (5, 1))
    t, j = BEMModel(verts, faces, 700.0, device="cpu"), JBEM(verts, faces, 700.0)
    for a, b in zip(t._matrices(), j._matrices()):
        b = np.asarray(b)
        assert a.dtype == torch.complex128
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
    phi_t, phi_j = t.boundary_equation_solve(psi), np.asarray(j.boundary_equation_solve(psi))
    np.testing.assert_allclose(phi_t.numpy(), phi_j, rtol=1e-10, atol=1e-12 * np.abs(phi_j).max())
    p_j = np.asarray(j.potential_solve(pts))
    np.testing.assert_allclose(t.potential_solve(pts).numpy(), p_j, rtol=1e-10)
    u = rng.normal(size=verts.shape)
    np.testing.assert_array_equal(t.mode_neumann_from_displacement(u, 2e3),
                                  j.mode_neumann_from_displacement(u, 2e3))


def test_potential_before_solve_raises():
    verts, faces = icosphere(1, radius=0.1)
    with pytest.raises(RuntimeError):
        BEMModel(verts, faces, 500.0, device="cpu").potential_solve(np.zeros((1, 3)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pulsating_sphere_magnitude(dtype):
    """Uniform radial velocity v on a sphere of radius a radiates
    |p(r)| = rho c v ka / sqrt(1 + (ka)^2) a / r; centroid quadrature on
    icosphere(3) is ~10% accurate (gate 15%, directions within 2%)."""
    a, freq, v = 0.1, 1000.0, 1.0
    k = 2 * np.pi * freq / SPEED_OF_SOUND
    verts, faces = icosphere(3, radius=a)
    model = BEMModel(verts, faces, freq, device="cpu", dtype=dtype)
    omega = 2 * np.pi * freq
    model.boundary_equation_solve(1j * omega * AIR_DENSITY * v * np.ones(len(faces)))
    p = model.potential_solve(np.eye(3))
    assert p.dtype == (torch.complex128 if dtype == torch.float64 else torch.complex64)
    p = np.abs(p.numpy())
    p_exact = AIR_DENSITY * SPEED_OF_SOUND * v * (k * a / np.sqrt(1 + (k * a) ** 2)) * a
    assert np.all(np.abs(p - p_exact) / p_exact < 0.15), (p, p_exact)
    assert np.std(p) / np.mean(p) < 0.02


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_farfield_decay(dtype):
    verts, faces = icosphere(2, radius=0.1)
    model = BEMModel(verts, faces, 500.0, device="cpu", dtype=dtype)
    model.boundary_equation_solve(np.ones(len(faces)) * 1j)
    p = np.abs(model.potential_solve(np.array([[1.0, 0, 0], [2.0, 0, 0]])).numpy())
    assert abs(p[0] / p[1] - 2.0) < 0.1  # 1/r decay
