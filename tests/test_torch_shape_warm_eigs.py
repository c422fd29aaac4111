"""The port's Ritz-refined eigenvalues against the JAX package's (values and
derivative, float64), and its warm shape eigensolver against host ARPACK
on the CPU: the remesh sequence of the JAX package's own warm test, the
forced and low-overlap re-anchors, the dump row of the scatter, and the
escalation round.  The warm solver's host anchors solve for its guard
columns (the JAX package seeds them with noise), so its output is held
against ARPACK, not against JAX's warm output bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.solvers.diff_eigs import ritz_refined_eigenvalues as jritz

from diffsound_torch.fem.mesh import icosphere
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.tasks import ThicknessTask
from diffsound_torch.solvers.diff_eigs import ritz_refined_eigenvalues

torch.set_num_threads(2)

MAT = (2700, 2.0e11, 0.29, 20, 3e-8)  # Steel, as tests/test_shape_tasks.py


def _pencil(n=40, k=7, seed=0):
    """K(p) = K0 + p K1, M(p) = M0 + p M1 (SPD), and a perturbed basis of
    the k lowest eigenvectors at p = 0.3 (an iterative solver's output)."""
    rng = np.random.default_rng(seed)
    q = lambda s: (lambda a: a @ a.T / n + s * np.eye(n))(rng.standard_normal((n, n)))
    K0, K1, M0 = q(0.5), q(0.1), q(1.0)
    M1 = 0.1 * q(0.1)
    p0 = 0.3
    Lc = np.linalg.cholesky(M0 + p0 * M1)
    Li = np.linalg.inv(Lc)
    w, V = np.linalg.eigh(Li @ (K0 + p0 * K1) @ Li.T)
    U = Li.T @ V[:, :k] + 1e-3 * rng.standard_normal((n, k))
    return (K0, K1, M0, M1), U, p0


@pytest.mark.parametrize("num_modes", [None, 5])
def test_ritz_refined_values_and_derivative_match_jax(num_modes):
    (K0, K1, M0, M1), U, p0 = _pencil()

    def jvals(p):
        return jritz(lambda x: (K0 + p * K1) @ x, lambda x: (M0 + p * M1) @ x,
                     jnp.asarray(U), num_modes)

    vj = np.asarray(jvals(jnp.asarray(p0)))
    dj = np.asarray(jax.jacfwd(jvals)(jnp.asarray(p0)))
    T = torch.as_tensor
    p = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    vt = ritz_refined_eigenvalues(lambda x: (T(K0) + p * T(K1)) @ x,
                                  lambda x: (T(M0) + p * T(M1)) @ x, T(U), num_modes)
    dt = torch.stack([torch.autograd.grad(v, p, retain_graph=True)[0] for v in vt])
    assert vt.shape == vj.shape
    assert np.abs(vt.detach().numpy() / vj - 1).max() <= 1e-12
    assert np.abs(dt.numpy() - dj).max() <= 1e-10 * np.abs(dj).max()
    # the values are the Ritz values of span(U): ascending, and above the
    # exact eigenvalues they approximate
    assert np.all(np.diff(vj) >= 0)


def _task(grid):
    t = ThicknessTask(grid_res=grid, scale=1.0, mat=MAT, mode_num=8, tets_dir="/nonexistent",
                      eig_method="warm", device="cpu")
    t.apply_sdf(*icosphere(2, radius=0.42))
    return t


@pytest.fixture()
def task():
    return _task(10)


def _march(task, coef):
    out = task._march(task.sdf, coef * task.max_thickness)
    return out, MarchingTets.compact(out)


def test_warm_solver_matches_host_over_a_remesh_sequence():
    """tests/test_shape_tasks.py::test_warm_eigensolver_matches_host's
    sequence at its grid: a cold anchor, then warm solves across two
    remeshes (7% of the second mesh's vertices are new slots), each within
    2e-4 of a fresh host ARPACK solve of the same mesh."""
    task = _task(12)
    assert task.warm.dtype == torch.float64 and task.warm.tol == 1e-4
    for i, coef in enumerate([0.5, 0.51, 0.52]):
        out, comp = _march(task, coef)
        if i == 1:
            assert task.warm.overlap(comp) < 0.95
        vals, U = task._eigensolve(out, comp)
        assert task.warm.last_mode == ("cold" if i == 0 else "warm")
        ref_vals, _ = task._eigensolve_host(out, comp)
        rel = np.abs(vals[6:] - ref_vals[6:]) / np.abs(ref_vals[6:])
        assert rel.max() < 2e-4, (i, rel.max())
        n = 3 * comp["num_verts"]
        U = torch.as_tensor(U)
        assert torch.isfinite(U[:n]).all() and not U[n:].any()
        if i:
            assert task.warm.last_resid <= task.warm.tol
    assert (task.warm.total_cold, task.warm.total_warm) == (1, 2)
    # the stored rows are the last solve's basis, in float32, at the mesh's
    # slots; the dump row took the pad rows
    keep = torch.as_tensor(comp["keep_idx"][: comp["num_verts"]])
    stored = task.warm.U_global[keep][:, :, : task.warm.k].reshape(-1, task.warm.k)
    assert torch.equal(stored, U[:n].to(torch.float32))


def test_request_anchor_forces_one_host_solve(task):
    """A requested anchor makes the next solve a host ARPACK solve (its
    values are those of ARPACK's solve for the modes and the guards, bit for
    bit) and the one after it warm again."""
    modes, k = [], task.warm.k
    for i, coef in enumerate([0.5, 0.51, 0.52, 0.53]):
        if i == 2:
            task.warm.request_anchor()
        out, comp = _march(task, coef)
        vals, _ = task._eigensolve(out, comp)
        modes.append(task.warm.last_mode)
        if i == 2:
            assert np.array_equal(vals, task._eigensolve_host(out, comp, task.warm.kg)[0][:k])
    assert modes == ["cold", "warm", "cold", "warm"]
    assert (task.warm.total_cold, task.warm.total_warm) == (2, 2)


def test_low_slot_overlap_forces_a_host_solve(task):
    """A remesh that leaves less than min_overlap of the new mesh's vertices
    in the stored basis re-anchors on the host instead of solving warm (the
    grid-10 shell's remeshes keep 65% or more of it, so the bar is raised
    here above the 0.5 -> 0.2 remesh's 68%)."""
    out, comp = _march(task, 0.5)
    task._eigensolve(out, comp)
    out2, comp2 = _march(task, 0.2)
    task.warm.min_overlap = 0.7
    assert task.warm.overlap(comp2) < task.warm.min_overlap
    vals, U = task._eigensolve(out2, comp2)
    assert task.warm.last_mode == "cold" and task.warm.total_cold == 2
    assert isinstance(U, np.ndarray)
    assert np.array_equal(vals, task._eigensolve_host(out2, comp2, task.warm.kg)[0][: task.warm.k])


def test_scatter_sends_pad_rows_to_the_dump_row(task):
    out, comp = _march(task, 0.5)
    keep = task.warm._keep_store(comp).numpy()
    nv = comp["num_verts"]
    assert len(keep) > nv  # the bucket pads
    assert np.array_equal(keep[:nv], comp["keep_idx"][:nv])
    assert np.all(keep[nv:] == task.warm.num_global_slots)
    assert len(np.unique(keep[:nv])) == nv


def test_escalation_round_recomputes_products_and_matches_host(task, monkeypatch):
    """tests/test_shape_tasks.py::test_warm_escalation_reuse_body_matches_host
    for the port's escalation body: a large jump whose first carried-products
    round caps runs a second round that recomputes its products, and then
    converges, is recorded as suspect, or re-anchors on the host."""
    task.warm.max_iters = 60
    out, comp = _march(task, 0.55)
    task._eigensolve(out, comp)
    assert task.warm.last_mode == "cold"
    rounds = []
    solve_once = task.warm._solve_once

    def spy(args, reuse):
        rounds.append(reuse)
        return solve_once(args, reuse)

    monkeypatch.setattr(task.warm, "_solve_once", spy)
    out2, comp2 = _march(task, 0.25)
    vals, _ = task._eigensolve(out2, comp2)
    assert rounds == [True, False]
    ref_vals, _ = task._eigensolve_host(out2, comp2)
    rel = np.abs(vals[6:] - ref_vals[6:]) / np.abs(ref_vals[6:])
    if task.warm.last_mode == "warm":
        assert task.warm.last_iterations == 2 * task.warm.max_iters
    if task.warm.last_mode == "warm" and task.warm.last_resid <= task.warm.tol:
        assert rel.max() < 2e-4
    elif task.warm.last_mode == "warm":
        assert task._grad_suspect() and rel.max() < 5e-2
    else:
        assert task.warm.last_mode == "cold-escalated" and rel.max() < 2e-4
