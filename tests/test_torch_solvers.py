"""Parity of the port's eigensolvers and differentiable eigenvalues with the
JAX package and scipy, in f64 on a small order-2 cube mesh."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.fem import assembly as jasm
from diffsound_tpu.models import sound_obj as jso
import importlib

jde = importlib.import_module("diffsound_tpu.solvers.diff_eigs")
jlo = importlib.import_module("diffsound_tpu.solvers.lobpcg")

from diffsound_torch.convert import (
    eigen_state_from_numpy, modal_cache_from_numpy, params_from_jax,
)
from diffsound_torch.fem import assembly as tasm
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.models import sound_obj as tso
from diffsound_torch.solvers import diff_eigs as tde
from diffsound_torch.solvers import lobpcg as tlo

torch.set_num_threads(2)

K_MODES = 14  # 6 rigid + 8 elastic; the spectrum has a wide gap above mode 14
MU, LAM = 1.1e7, 0.9e7  # density-normalized Lame values (E/rho scale)


@pytest.fixture(scope="module")
def pencil():
    m = cube_tet_mesh(2, 0.5).to_high_order(2)
    to = tasm.build_element_ops(torch.as_tensor(m.vertices), m.tets, 2, dtype=torch.float64)
    jo = jasm.build_element_ops(jnp.asarray(m.vertices), jnp.asarray(m.tets), 2,
                                dtype=jnp.float64)
    return m, to, jo


def _scaled_fns_torch(to, mu, lam):
    dsc = torch.rsqrt(tasm.k_diag(to, mu, lam))[:, None]
    fz = tasm.freeze_stiffness(to, mu, lam)
    a = lambda y: dsc * tasm.k_matvec_frozen(to, fz, dsc * y)
    b = lambda y: dsc * tasm.m_matvec(to, dsc * y, 1.0)
    return dsc, a, b


def _scaled_fns_jax(jo, mu, lam):
    dsc = jax.lax.rsqrt(jasm.k_diag(jo, mu, lam))[:, None]
    a = lambda y: dsc * jasm.k_matvec(jo, dsc * y, mu, lam)
    b = lambda y: dsc * jasm.m_matvec(jo, dsc * y, 1.0)
    return dsc, a, b


def _check_solution(to, vals, vecs, mu, lam, ref_vals, tol):
    vals, vecs = vals.numpy(), vecs.numpy()
    np.testing.assert_allclose(vals[6:], ref_vals[6:], rtol=1e-8)
    assert np.abs(vals[:6]).max() < 1e-8 * ref_vals[-1]  # rigid-body block
    K, M = tasm.assemble_scipy(to, mu, lam, 1.0)
    gram = vecs.T @ (M @ vecs)
    assert np.abs(gram - np.eye(len(vals))).max() <= 1e-10


def test_lobpcg_cold_and_warm_match_scipy_and_jax(pencil):
    m, to, jo = pencil
    K, M = tasm.assemble_scipy(to, MU, LAM, 1.0)
    ref = scipy.linalg.eigh(K.toarray(), M.toarray(), eigvals_only=True)[:K_MODES]
    n = 3 * m.num_vertices
    x0 = np.random.default_rng(1).standard_normal((n, K_MODES))

    dsc_t, a_t, b_t = _scaled_fns_torch(to, MU, LAM)
    dsc_j, a_j, b_j = _scaled_fns_jax(jo, MU, LAM)
    tol = 1e-8
    cold_t = tlo.lobpcg(a_t, b_t, torch.as_tensor(x0) / dsc_t, max_iters=300, tol=tol)
    cold_j = jlo.lobpcg(a_j, b_j, jnp.asarray(x0) / dsc_j, max_iters=300, tol=tol)
    assert cold_t.iterations < 300
    assert float(cold_t.residual_norms.max()) <= tol
    _check_solution(to, cold_t.eigenvalues, dsc_t * cold_t.eigenvectors, MU, LAM, ref, tol)
    np.testing.assert_allclose(cold_t.eigenvalues.numpy()[6:],
                               np.asarray(cold_j.eigenvalues)[6:], rtol=1e-8)

    # warm start after a 2% material change, from the same converged basis
    mu2, lam2 = 1.02 * MU, LAM / 1.02
    K2, M2 = tasm.assemble_scipy(to, mu2, lam2, 1.0)
    ref2 = scipy.linalg.eigh(K2.toarray(), M2.toarray(), eigvals_only=True)[:K_MODES]
    u0 = (dsc_t * cold_t.eigenvectors).numpy()
    dsc_t2, a_t2, b_t2 = _scaled_fns_torch(to, mu2, lam2)
    dsc_j2, a_j2, b_j2 = _scaled_fns_jax(jo, mu2, lam2)
    # one compiled JAX solve for every seed
    warm_j = jax.jit(lambda x0, seed: jlo.lobpcg(a_j2, b_j2, x0, max_iters=300, tol=1e-6,
                                                 seed=seed))
    for seed in range(3):
        warm_t = tlo.lobpcg(a_t2, b_t2, torch.as_tensor(u0) / dsc_t2, max_iters=300,
                            tol=tol, seed=seed, record_history=True)
        assert float(warm_t.residual_norms.max()) <= tol
        _check_solution(to, warm_t.eigenvalues, dsc_t2 * warm_t.eigenvectors, mu2, lam2,
                        ref2, tol)
        hist = warm_t.history.numpy()
        assert np.isfinite(hist[: warm_t.iterations]).all()
        assert np.isnan(hist[warm_t.iterations:]).all()
        assert warm_t.iterations < cold_t.iterations

        # Warm iterations of each solve against JAX's with the same seed,
        # at tol 1e-6, where convergence is still linear: at 1e-8 the last
        # modes stall on the pencil's f64 residual floor and rounding sets
        # the count (given the very same P block, the two packages end up
        # to ten iterations apart there).
        its_t = tlo.lobpcg(a_t2, b_t2, torch.as_tensor(u0) / dsc_t2, max_iters=300,
                           tol=1e-6, seed=seed).iterations
        its_j = int(warm_j(jnp.asarray(u0) / dsc_j2, seed).iterations)
        assert abs(its_t - its_j) <= 2, (seed, its_t, its_j)


def test_lobpcg_reuse_products_warm_f64(pencil):
    """The f32 production body (carried A S / B S) also converges in f64."""
    m, to, jo = pencil
    K, M = tasm.assemble_scipy(to, MU, LAM, 1.0)
    ref = scipy.linalg.eigh(K.toarray(), M.toarray(), eigvals_only=True)[:K_MODES]
    vals, vecs = scipy.linalg.eigh(K.toarray() * 1.01, M.toarray())
    dsc, a, b = _scaled_fns_torch(to, MU, LAM)
    res = tlo.lobpcg(a, b, torch.as_tensor(vecs[:, :K_MODES]) / dsc, max_iters=40,
                     tol=1e-6, reuse_products=True, num_wanted=K_MODES - 2)
    assert float(res.residual_norms[: K_MODES - 2].max()) <= 1e-6
    np.testing.assert_allclose(res.eigenvalues.numpy()[6:K_MODES - 2],
                               ref[6:K_MODES - 2], rtol=1e-8)


def test_jacobi_preconditioner():
    d = np.array([2.0, 0.0, -1.0, 4.0])
    r = np.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(
        tlo.jacobi_preconditioner(torch.as_tensor(d))(torch.as_tensor(r)).numpy(),
        np.asarray(jlo.jacobi_preconditioner(jnp.asarray(d))(jnp.asarray(r))),
    )


def test_rayleigh_correction_and_frequencies(pencil):
    m, to, jo = pencil
    K, M = tasm.assemble_scipy(to, MU, LAM, 1.0)
    vals, vecs = scipy.linalg.eigh(K.toarray(), M.toarray())
    vals, vecs = vals[:K_MODES], vecs[:, :K_MODES]

    def f_j(mu, lam):
        lt = jde.rayleigh_corrected_eigenvalues(
            lambda x: jasm.k_matvec(jo, x, mu, lam), lambda x: jasm.m_matvec(jo, x, 1.0),
            jnp.asarray(vals), jnp.asarray(vecs),
        )
        return jnp.sum(jde.undamped_frequencies(lt) * jnp.arange(1.0, K_MODES + 1)), lt

    (sj, lt_j), gj = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(MU, LAM)

    mu = torch.tensor(MU, dtype=torch.float64, requires_grad=True)
    lam = torch.tensor(LAM, dtype=torch.float64, requires_grad=True)
    lt_t = tde.rayleigh_corrected_eigenvalues(
        lambda x: tasm.k_matvec(to, x, mu, lam), lambda x: tasm.m_matvec(to, x, 1.0),
        torch.as_tensor(vals), torch.as_tensor(vecs),
    )
    st = (tde.undamped_frequencies(lt_t) * torch.arange(1.0, K_MODES + 1,
                                                        dtype=torch.float64)).sum()
    gt = torch.autograd.grad(st, (mu, lam))
    np.testing.assert_allclose(lt_t.detach().numpy()[6:], np.asarray(lt_j)[6:], rtol=1e-10)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-10)
    np.testing.assert_allclose([float(g) for g in gt], [float(g) for g in gj], rtol=1e-10)

    # the 1e-3 floor: values and (zero) gradients below it
    x = np.array([-5.0, 0.0, 1e-4, 2.5e4, 4e8])
    xt = torch.as_tensor(x).requires_grad_(True)
    ft = tde.undamped_frequencies(xt)
    (g_t,) = torch.autograd.grad(ft.sum(), xt)
    fj, vjp = jax.vjp(jde.undamped_frequencies, jnp.asarray(x))
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp(jnp.ones(5))[0]), rtol=1e-10)


def test_sound_object_cache_and_param_grads():
    """Same params and eigenpairs in both packages: the modal cache, cached
    and matvec corrected eigenvalues, frequencies and d(freqs)/d(params)."""
    mesh = cube_tet_mesh(2, 0.5)
    mat = (2700, 7.2e10, 0.19, 6, 1e-7)
    jm = jso.build_model(mesh=mesh, mode_num=6, order=2, mat=mat, task="material",
                         dtype=jnp.float64)
    tm = tso.build_model(mesh=mesh, mode_num=6, order=2, mat=mat, task="material",
                         dtype=torch.float64, device="cpu")
    eig_j = jm.eigen_decomposition(method="arpack")
    eig_t = tm.eigen_decomposition()
    np.testing.assert_allclose(eig_t.eigenvalues.numpy()[6:],
                               np.asarray(eig_j.eigenvalues)[6:], rtol=1e-10)

    # f64 logits in both packages: f32 param math cannot agree bit for bit
    # (the two frameworks' exp/log1p differ in the last ulp)
    p64 = {k: np.asarray(v, np.float64)
           for k, v in jm.init_params(jax.random.PRNGKey(3), pretrain=False).items()}
    pj = {k: jnp.asarray(v) for k, v in p64.items()}
    pt = params_from_jax(p64, dtype=torch.float64)
    for v in pt.values():
        v.requires_grad_(True)
    eig_t = eigen_state_from_numpy(np.asarray(eig_j.eigenvalues),
                                   np.asarray(eig_j.eigenvectors), torch.float64)
    cache_j, cache_t = jm.modal_cache(eig_j), tm.modal_cache(eig_t)
    for name in ("q_mu", "q_lam", "q_m"):
        q = np.asarray(getattr(cache_j, name))
        np.testing.assert_allclose(getattr(cache_t, name).numpy(), q, rtol=1e-10,
                                   atol=1e-10 * np.abs(q).max())

    w = np.linspace(1.0, 2.0, 6)

    def fj(p):
        return jnp.sum(jm.get_undamped_freqs_cached(p, cache_j) * w)

    vj, gj = jax.value_and_grad(fj)(pj)
    ft = tm.get_undamped_freqs_cached(pt, cache_t)
    vt = (ft * torch.as_tensor(w)).sum()
    gt = torch.autograd.grad(vt, list(pt.values()))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
    for g, k in zip(gt, pt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), rtol=1e-9)
    # cached == matvec path inside the port
    np.testing.assert_allclose(
        tm.get_undamped_freqs(pt, eig_t).detach().numpy(), ft.detach().numpy(), rtol=1e-9
    )
    # JAX's own cache carried across gives the same frequencies
    carried = modal_cache_from_numpy(
        *(np.asarray(getattr(cache_j, n)) for n in ("eigenvalues", "q_mu", "q_lam", "q_m")),
        dtype=torch.float64,
    )
    np.testing.assert_allclose(
        tm.get_undamped_freqs_cached(pt, carried).detach().numpy(), ft.detach().numpy(),
        rtol=1e-10,
    )


def test_noise_guard_columns_do_not_pass_the_wanted_block():
    """A warm start from the previous geometry's exact basis plus noise guard
    columns (the warm shape solver's first solve after a host re-anchor), on
    a mesh with one thin layer of cells (the spectrum spans 2.4e7 x, as a
    marching-tets mesh's slivers make it).  The exit test scales each wanted
    column's residual by the block's largest Ritz value capped at
    `GUARD_SCALE_CAP` times the wanted block's: scaled by the noise guards'
    (as the JAX package's `lobpcg` does) it passed at the first check,
    residual 1.2e-4, with eigenvalues 2.9e-3 from the truth."""
    m = cube_tet_mesh(4, 0.5)
    v = m.vertices.copy()
    xs = np.unique(np.round(v[:, 0], 9))
    h = xs[1] - xs[0]
    v[np.isclose(v[:, 0], xs[-1]), 0] = xs[-2] + 1e-3 * h
    k, guards = K_MODES, 8
    to = tasm.build_element_ops(torch.as_tensor(v), m.tets, 1, dtype=torch.float64)
    K, M = tasm.assemble_scipy(to, MU, LAM, 1.0)
    _, vecs = scipy.linalg.eigh(K.toarray(), M.toarray())
    # the next geometry: the vertices off the thin layer moved by 3% of a cell
    rng = np.random.default_rng(3)
    moved = v + 0.03 * h * rng.standard_normal(v.shape) * (v[:, :1] < xs[-2] - 1e-9)
    to2 = tasm.build_element_ops(torch.as_tensor(moved), m.tets, 1, dtype=torch.float64)
    K2, M2 = tasm.assemble_scipy(to2, MU, LAM, 1.0)
    ref = scipy.linalg.eigh(K2.toarray(), M2.toarray(), eigvals_only=True)[:k]
    dsc, a, b = _scaled_fns_torch(to2, MU, LAM)
    noise = np.random.default_rng(4).standard_normal((vecs.shape[0], guards))
    x0 = torch.as_tensor(np.concatenate([vecs[:, :k], noise], 1)) / dsc
    res = tlo.lobpcg(a, b, x0, max_iters=100, tol=3e-3, reuse_products=True, num_wanted=k)
    got = res.eigenvalues.numpy()[6:k]
    assert float(res.residual_norms[:k].max()) <= 3e-3 and res.iterations > 1
    assert np.abs(got / ref[6:] - 1).max() < 1e-3
