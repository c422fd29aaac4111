"""Parity of the port's stress path and FEM leftovers with the JAX package,
in float64 on the CPU: `k_matvec_stress` through `linear_stress` equals the
factored `k_matvec` (rtol 1e-9, as tests/test_fem_core.py holds the JAX
package) and JAX's own stress path (rtol 1e-12); `TinyNN` from the same
numpy params gives JAX's stress, quadratic form and parameter gradients
(rtol 1e-10) and elasticity jacobian; `elasticity_tensor`, `m_lumped`,
`FEMOperators`, the transforms, `lobpcg_solver_freq` and
`TetMesh.largest_connected_component` as tests/test_fem_core.py and
tests/test_solvers.py check them."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.fem import assembly as jasm
from diffsound_tpu.fem import material as jmat
from diffsound_tpu.fem import mesh as jmesh
from diffsound_tpu.fem import transform as jtr
from diffsound_tpu.solvers.lobpcg import lobpcg_solver_freq as j_freq

from diffsound_torch.fem import assembly as tasm
from diffsound_torch.fem import material as tmat
from diffsound_torch.fem import mesh as tmesh
from diffsound_torch.fem import transform as ttr
from diffsound_torch.solvers.lobpcg import lobpcg_solver_freq as t_freq

torch.set_num_threads(2)

YOUNGS, POISSON = 2.1e7, 0.3


def _ops(mesh, order):
    v = torch.as_tensor(mesh.vertices)
    return (tasm.build_element_ops(v, mesh.tets, order, dtype=torch.float64),
            tasm.build_deform_ops(v, mesh.tets, order, dtype=torch.float64))


@pytest.mark.parametrize("order", [1, 2])
def test_linear_stress_path_matches_factored_path_and_jax(order):
    mesh = tmesh.cube_tet_mesh(2, size=1.0).to_high_order(order) if order > 1 \
        else tmesh.cube_tet_mesh(2, size=1.0)
    mu, lam = tmat.lame_params(YOUNGS, POISSON)
    ops, dops = _ops(mesh, order)
    x = np.random.default_rng(0).normal(size=(3 * mesh.num_vertices, 5))
    xt = torch.as_tensor(x)
    y_fact = tasm.k_matvec(ops, xt, mu, lam).numpy()
    y_stress = tasm.k_matvec_stress(
        dops, lambda F: tmat.linear_stress(F, YOUNGS, POISSON), xt).numpy()
    np.testing.assert_allclose(y_stress, y_fact, rtol=1e-9, atol=1e-9 * np.abs(y_fact).max())

    v, t = jnp.asarray(mesh.vertices), jnp.asarray(mesh.tets)
    jd = jasm.build_deform_ops(v, t, order, dtype=jnp.float64)
    np.testing.assert_allclose(dops.B.numpy(), np.asarray(jd.B), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dops.w.numpy(), np.asarray(jd.w), rtol=1e-12)
    F_j = jasm.deformation_gradients(jd, jnp.asarray(x))
    np.testing.assert_allclose(tasm.deformation_gradients(dops, xt).numpy(), np.asarray(F_j),
                               rtol=1e-12, atol=1e-12 * float(jnp.abs(F_j).max()))
    y_j = np.asarray(jasm.k_matvec_stress(
        jd, lambda F: jmat.linear_stress(F, YOUNGS, POISSON), jnp.asarray(x)))
    np.testing.assert_allclose(y_stress, y_j, rtol=1e-12, atol=1e-12 * np.abs(y_j).max())


def test_masked_deform_ops_zero_the_masked_tets():
    mesh = tmesh.cube_tet_mesh(2, size=1.0)
    mask = np.ones(mesh.num_tets)
    mask[::3] = 0.0
    v = torch.as_tensor(mesh.vertices)
    dops = tasm.build_deform_ops(v, mesh.tets, 1, dtype=torch.float64,
                                 tet_mask=torch.as_tensor(mask))
    jd = jasm.build_deform_ops(jnp.asarray(mesh.vertices), jnp.asarray(mesh.tets), 1,
                               dtype=jnp.float64, tet_mask=jnp.asarray(mask))
    np.testing.assert_allclose(dops.w.numpy(), np.asarray(jd.w), rtol=1e-12)
    assert (dops.w.numpy()[::3] == 0).all()


def test_tinynn_stress_path_matches_jax_and_differentiates():
    mesh = tmesh.cube_tet_mesh(2, size=1.0)
    _, dops = _ops(mesh, 1)
    jnn = jmat.TinyNN(mid_dim=16, stress_scale=1e5)
    jp = jnn.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    tnn = tmat.TinyNN(mid_dim=16, stress_scale=1e5, dtype=torch.float64)
    tnn.load_state_dict({k: torch.tensor(np.array(v)) for k, v in jp.items()})
    x = np.random.default_rng(1).normal(size=(3 * mesh.num_vertices, 3))

    jd = jasm.build_deform_ops(jnp.asarray(mesh.vertices), jnp.asarray(mesh.tets), 1,
                               dtype=jnp.float64)
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jnp.asarray(x) * jasm.k_matvec_stress(jd, jnn.stress_fn(p),
                                                                jnp.asarray(x)))))(jp)
    xt = torch.as_tensor(x)
    val_t = (xt * tasm.k_matvec_stress(dops, tnn.stress_fn(), xt)).sum()
    grads = torch.autograd.grad(val_t, list(tnn.parameters()))
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-10)
    for (name, _), g in zip(tnn.named_parameters(), grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[name]), rtol=1e-10,
                                   atol=1e-10 * float(jnp.abs(g_j[name]).max()), err_msg=name)
    assert max(float(g.abs().max()) for g in grads) > 0
    C = tnn.jacobian_F()
    assert C.shape == (9, 9) and C.dtype == torch.float64 and torch.isfinite(C).all()
    np.testing.assert_allclose(C.numpy(), np.asarray(jnn.jacobian_F(jp)), rtol=1e-12, atol=1e-9)


def test_elasticity_tensor_and_linear_jacobians():
    """With non_linear False and a tiny stress the tanh is linear to 1e-12,
    so the jacobian at F = 0 is w1 w2 w3 scaled; and elasticity_tensor
    equals the JAX package's and is linear_stress's jacobian."""
    C_t = tmat.elasticity_tensor(YOUNGS, POISSON)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(jmat.elasticity_tensor(YOUNGS, POISSON)),
                               rtol=1e-15)
    jac = torch.func.jacrev(lambda f: tmat.linear_stress(f.reshape(3, 3), YOUNGS, POISSON)
                            .reshape(9))(torch.zeros(9, dtype=torch.float64))
    np.testing.assert_allclose(jac.numpy(), C_t.numpy(), rtol=1e-15)
    nn_lin = tmat.TinyNN(mid_dim=8, non_linear=False, stress_scale=1.0, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(3))
    want = (nn_lin.w1 @ nn_lin.w2 @ nn_lin.w3).detach()  # (9, 9): sigma = f @ W at f ~ 0
    np.testing.assert_allclose(nn_lin.jacobian_F().numpy(), want.T.numpy(), rtol=1e-12)


def test_m_lumped_and_fem_operators_match_jax():
    mesh = tmesh.cube_tet_mesh(2, size=1.0).to_high_order(2)
    jm = jmesh.TetMesh(mesh.vertices, mesh.tets, order=2)
    jops = jasm.FEMOperators(jm, dtype=jnp.float64)
    tops = tasm.FEMOperators(mesh, device="cpu")
    assert tops.dtype == torch.float64 and tops.num_dof == jops.num_dof
    np.testing.assert_allclose(tasm.m_lumped(tops.ops, 2.5).numpy(),
                               np.asarray(jasm.m_lumped(jops.ops, 2.5)), rtol=1e-12)
    x = np.random.default_rng(2).normal(size=(tops.num_dof, 4))
    mu, lam = tmat.lame_params(YOUNGS, POISSON)
    for t_y, j_y in ((tops.k_matvec(torch.as_tensor(x), mu, lam),
                      jops.k_matvec(jnp.asarray(x), mu, lam)),
                     (tops.m_matvec(torch.as_tensor(x), 2.5), jops.m_matvec(jnp.asarray(x), 2.5))):
        j_y = np.asarray(j_y)
        np.testing.assert_allclose(t_y.numpy(), j_y, rtol=1e-12, atol=1e-12 * np.abs(j_y).max())
    # lumped mass sums to the total mass: density x volume, times 3 directions
    assert abs(float(tasm.m_lumped(tops.ops, 1.0).sum()) - 3 * mesh.volumes().sum()) < 1e-12


def test_transforms_round_trip_and_match_jax():
    rng = np.random.default_rng(0)
    mesh = tmesh.cube_tet_mesh(2, size=1.0)
    c = mesh.corner_tets()
    A = mesh.transform_matrices()
    b = mesh.vertices[c[:, 3]]
    r = rng.dirichlet([1, 1, 1, 1], size=len(c))[:, :3]
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    p = ttr.compute_inv_transform_coord(torch.as_tensor(r), At, bt)
    np.testing.assert_allclose(p.numpy(), np.asarray(jtr.compute_inv_transform_coord(
        jnp.asarray(r), jnp.asarray(A), jnp.asarray(b))), rtol=1e-15, atol=1e-15)
    back = ttr.compute_transform_coord(p, At, bt)
    np.testing.assert_allclose(back.numpy(), r, atol=1e-12)
    bc = ttr.barycentric_coordinates(torch.as_tensor(mesh.vertices[c[:, 0]]), At, bt)
    np.testing.assert_allclose(bc.numpy(), np.tile([1.0, 0, 0, 0], (len(c), 1)), atol=1e-12)
    np.testing.assert_allclose(bc.numpy(), np.asarray(jtr.barycentric_coordinates(
        jnp.asarray(mesh.vertices[c[:, 0]]), jnp.asarray(A), jnp.asarray(b))), atol=1e-14)


def test_freq_cutoff_wrapper_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    n = 40
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 400.0, n) ** 2) @ Q.T
    B = np.eye(n) + 0.1 * np.diag(rng.uniform(size=n))
    x0 = rng.normal(size=(n, 10))
    ref = scipy.linalg.eigh(A, B, eigvals_only=True)
    lim = float(np.sqrt(ref[7]) / (2 * np.pi)) + 1e-9
    kw = dict(freq_limit=lim, rigid_modes=2, max_iters=300, tol=1e-10)
    vals, vecs = t_freq(lambda x: torch.as_tensor(A) @ x, lambda x: torch.as_tensor(B) @ x,
                        torch.as_tensor(x0), **kw)
    np.testing.assert_allclose(vals, ref[2:8], rtol=1e-6)
    assert vecs.shape == (n, len(vals))
    jv, _ = j_freq(lambda x: jnp.asarray(A) @ x, lambda x: jnp.asarray(B) @ x,
                   jnp.asarray(x0), **kw)
    np.testing.assert_allclose(vals, np.asarray(jv), rtol=1e-8)


def test_largest_connected_component_matches_jax():
    a = tmesh.cube_tet_mesh(1)
    b = tmesh.cube_tet_mesh(2)
    verts = np.concatenate([a.vertices, b.vertices + 10.0])
    tets = np.concatenate([a.tets, b.tets + a.num_vertices])
    m = tmesh.TetMesh(verts, tets).largest_connected_component()
    jm = jmesh.TetMesh(verts, tets).largest_connected_component()
    assert m.num_tets == b.num_tets
    np.testing.assert_array_equal(m.tets, jm.tets)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    assert tmesh.TetMesh(b.vertices, b.tets).largest_connected_component().num_tets == b.num_tets
