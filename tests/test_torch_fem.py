"""Parity of the port's FEM layer (diffsound_torch.fem) with the JAX package:
numpy copies bit-equal, element operators and matvecs to rtol 1e-12 in f64,
vertex gradients through build_element_ops to rtol 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.fem import assembly as jasm
from diffsound_tpu.fem import mesh as jmesh
from diffsound_tpu.fem import quadrature as jquad
from diffsound_tpu.fem import shape_func as jshape
from diffsound_tpu.native import meshops

from diffsound_torch.fem import assembly as tasm
from diffsound_torch.fem import mesh as tmesh
from diffsound_torch.fem import quadrature as tquad
from diffsound_torch.fem import shape_func as tshape

torch.set_num_threads(2)

RTOL = 1e-12


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_quadrature_and_shape_functions_bit_equal(order):
    p_j, w_j = jquad.gauss_tet_quadrature(order)
    p_t, w_t = tquad.gauss_tet_quadrature(order)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(w_t, w_j)
    if order <= 3:
        np.testing.assert_array_equal(
            tshape.shape_function(p_t, order), jshape.shape_function(p_j, order)
        )
        np.testing.assert_array_equal(
            tshape.shape_function_grad(p_t, order), jshape.shape_function_grad(p_j, order)
        )


@pytest.mark.parametrize("n,size", [(2, 1.0), (3, 0.5)])
def test_mesh_copies_bit_equal(n, size, tmp_path):
    mj, mt = jmesh.cube_tet_mesh(n, size), tmesh.cube_tet_mesh(n, size)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.tets, mj.tets)
    np.testing.assert_array_equal(mt.volumes(), mj.volumes())

    h_t = mt.to_high_order(2)
    if meshops.native_available():
        h_j = mj.to_high_order(2)
    else:  # the JAX package numbers edge nodes first-seen only natively
        h_j = jmesh.TetMesh(*meshops.promote_order2(mj.vertices, mj.tets), order=2)
    np.testing.assert_array_equal(h_t.vertices, h_j.vertices)
    np.testing.assert_array_equal(h_t.tets, h_j.tets)

    o3_t, o3_j = mt.to_high_order(3), mj.to_high_order(3)
    np.testing.assert_array_equal(o3_t.vertices, o3_j.vertices)
    np.testing.assert_array_equal(o3_t.tets, o3_j.tets)

    for order, m in ((1, mt), (2, h_t)):
        np.testing.assert_array_equal(
            tasm.build_gather_transpose(m.tets, m.num_vertices),
            jasm.build_gather_transpose(m.tets, m.num_vertices),
        )

    # msh round trip through both readers
    path = str(tmp_path / "cube.msh")
    tmesh.write_msh(path, h_t.vertices, h_t.tets, order=2)
    vt, tt = tmesh.read_msh(path)
    vj, tj = jmesh.read_msh(path)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    rt = tmesh.TetMesh.from_file(path)
    rj = jmesh.TetMesh.from_file(path)
    np.testing.assert_array_equal(rt.vertices, rj.vertices)
    np.testing.assert_array_equal(rt.tets, rj.tets)


def _meshes(order):
    m = tmesh.cube_tet_mesh(2, 1.0)
    return m if order == 1 else m.to_high_order(order)


def _ops_pair(order):
    m = _meshes(order)
    jo = jasm.build_element_ops(
        jnp.asarray(m.vertices), jnp.asarray(m.tets), order, dtype=jnp.float64
    )
    to = tasm.build_element_ops(torch.as_tensor(m.vertices), m.tets, order, dtype=torch.float64)
    return m, jo, to


@pytest.mark.parametrize("order", [1, 2])
def test_element_ops_and_matvecs(order):
    m, jo, to = _ops_pair(order)
    for name in ("k_mu", "k_lam", "mass_scale", "mref"):
        np.testing.assert_allclose(
            getattr(to, name).numpy(), np.asarray(getattr(jo, name)), rtol=RTOL, atol=1e-14,
            err_msg=name,
        )
    rng = np.random.default_rng(order)
    x = rng.standard_normal((3 * m.num_vertices, 5))
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    mu, lam, rho = 1.3e7, 2.1e7, 0.7

    kj = np.asarray(jasm.k_matvec(jo, xj, mu, lam))
    np.testing.assert_allclose(tasm.k_matvec(to, xt, mu, lam).numpy(), kj, rtol=RTOL,
                               atol=RTOL * np.abs(kj).max())
    # the port freezes one combined block (no bf16 split): same K @ X
    kf = tasm.k_matvec_frozen(to, tasm.freeze_stiffness(to, mu, lam), xt).numpy()
    np.testing.assert_allclose(kf, kj, rtol=RTOL, atol=RTOL * np.abs(kj).max())

    mj = np.asarray(jasm.m_matvec(jo, xj, rho))
    np.testing.assert_allclose(tasm.m_matvec(to, xt, rho).numpy(), mj, rtol=RTOL,
                               atol=RTOL * np.abs(mj).max())
    np.testing.assert_allclose(tasm.k_diag(to, mu, lam).numpy(),
                               np.asarray(jasm.k_diag(jo, mu, lam)), rtol=RTOL)
    np.testing.assert_allclose(tasm.m_diag(to, rho).numpy(),
                               np.asarray(jasm.m_diag(jo, rho)), rtol=RTOL)

    Kt, Mt = tasm.assemble_scipy(to, mu, lam, rho)
    Kj, Mj = jasm.assemble_scipy(jo, mu, lam, rho)
    np.testing.assert_allclose(Kt.toarray(), Kj.toarray(), rtol=RTOL,
                               atol=RTOL * abs(Kj).max())
    np.testing.assert_allclose(Mt.toarray(), Mj.toarray(), rtol=RTOL,
                               atol=RTOL * abs(Mj).max())
    # the gather-sum scatter agrees with the assembled sparse product
    np.testing.assert_allclose(Kt @ x, kj, rtol=1e-10, atol=1e-10 * np.abs(kj).max())


def test_inv3x3_guard():
    A = np.zeros((2, 3, 3))
    A[0] = np.diag([2.0, 3.0, 4.0])
    det_t, inv_t = tasm.inv3x3(torch.as_tensor(A), safe=True)
    det_j, inv_j = jasm.inv3x3(jnp.asarray(A), safe=True)
    np.testing.assert_array_equal(det_t.numpy(), np.asarray(det_j))
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    assert np.isfinite(inv_t.numpy()).all()


@pytest.mark.parametrize("order", [1, 2])
def test_vertex_gradient_matches_jax(order):
    m = _meshes(order)
    rng = np.random.default_rng(10 + order)
    verts = m.vertices + 0.03 * rng.standard_normal(m.vertices.shape)
    n3 = 3 * m.tets.shape[1]
    w_mu = rng.standard_normal((m.num_tets, n3, n3))
    w_lam = rng.standard_normal((m.num_tets, n3, n3))
    w_m = rng.standard_normal(m.num_tets)

    def scalar_j(v):
        o = jasm.build_element_ops(v, jnp.asarray(m.tets), order, dtype=jnp.float64)
        return jnp.sum(o.k_mu * w_mu) + jnp.sum(o.k_lam * w_lam) + jnp.sum(o.mass_scale * w_m)

    gj = np.asarray(jax.grad(scalar_j)(jnp.asarray(verts)))

    vt = torch.as_tensor(verts).requires_grad_(True)
    o = tasm.build_element_ops(vt, m.tets, order, dtype=torch.float64)
    s = (o.k_mu * torch.as_tensor(w_mu)).sum() + (o.k_lam * torch.as_tensor(w_lam)).sum() \
        + (o.mass_scale * torch.as_tensor(w_m)).sum()
    (gt,) = torch.autograd.grad(s, vt)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10 * np.abs(gj).max())


@pytest.mark.parametrize("order", [1, 2])
def test_card_gather_sum_equals_the_cpu_scatter(order):
    """_scatter sums element-node rows by index_add_ on the CPU and by the
    gather-sum through gather_idx on the card (no atomics there): on the
    same rows the two agree to the last bits of float64 (1e-13)."""
    m, _, to = _ops_pair(order)
    E, N = to.tets.shape
    ye = torch.as_tensor(np.random.default_rng(order).standard_normal((E, 3 * N, 4)))
    got = tasm._scatter(to, ye).reshape(m.num_vertices, 12)
    want = tasm.gather_sum(ye.reshape(E * N, 12), to.gather_idx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))
