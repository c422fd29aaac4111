"""Parity of the port's modal-Newton fit (models/modal_fit.py) and of the
eigensolve options it and the trainer use (models/sound_obj.py) with the
JAX package, in f64: the free functions on identical inputs, and the whole
fit on the small cube of tests/test_modal_fit.py, recovering (E, nu) from
synthesized audio alone."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsound_tpu.audio.freq_loss import extract_spectral_peaks
from diffsound_tpu.audio.oscillator import TraditionalOscillatorParams as JOsc
from diffsound_tpu.fem.material import Material as JMaterial
from diffsound_tpu.fem.material import lame_params
from diffsound_tpu.models import modal_fit as jmf
from diffsound_tpu.models.sound_obj import build_model as jbuild

from diffsound_torch.convert import eigen_state_from_numpy
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.models import modal_fit as tmf
from diffsound_torch.models.sound_obj import build_model

torch.set_num_threads(2)

SR = 32000.0


def _fd_and_peaks(seed, k=14, P=12):
    rng = np.random.default_rng(seed)
    peaks = np.sort(rng.uniform(200, 15500, P))
    pw = rng.uniform(0.1, 1.0, P)
    pw /= pw.sum()
    # predictions near the peaks, some folded above Nyquist, one far off
    fd = np.concatenate([peaks[: k - 4] * rng.uniform(0.97, 1.03, k - 4),
                         SR - peaks[:3] * 1.01, [40000.0]])
    return fd, peaks, pw


def test_damping_inversion_and_unfolding_match_jax():
    fd = np.logspace(1.5, 4.3, 30)
    for alpha, beta in ((6.0, 1e-7), (6.0, 0.0), (60.0, 2e-6)):
        np.testing.assert_array_equal(tmf.lambda_from_damped_freq(fd, alpha, beta),
                                      jmf.lambda_from_damped_freq(fd, alpha, beta))
    for fp in (123.0, 15000.0):
        np.testing.assert_array_equal(tmf.unfold_candidates(fp, SR, 3),
                                      jmf.unfold_candidates(fp, SR, 3))
    assert tmf.lame_to_E_nu(2.5e7, 1.4e7) == jmf.lame_to_E_nu(2.5e7, 1.4e7)


@pytest.mark.parametrize("ratio", [0.56, 1000.0])  # nu ~ 0.18, and nu > 0.499 (clamped)
def test_modal_lsq_fit_matches_jax(ratio):
    rng = np.random.default_rng(3)
    k = 12
    q_mu, q_lam = rng.uniform(1e5, 1e7, k), rng.uniform(1e4, 1e6, k)
    q_m = np.ones(k) + rng.normal(0, 1e-6, k)
    lam0 = rng.uniform(1e6, 1e9, k)
    tgt = lam0 * (1 - q_m) + 2.5e7 * q_mu + ratio * 2.5e7 * q_lam
    tgt *= 1 + rng.normal(0, 1e-3, k)
    w = rng.uniform(0.2, 1.0, k)
    assert tmf.modal_lsq_fit(lam0, q_mu, q_lam, q_m, tgt, w) == \
        jmf.modal_lsq_fit(lam0, q_mu, q_lam, q_m, tgt, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_assignment_and_scale_scan_match_jax(seed):
    fd, peaks, pw = _fd_and_peaks(seed)
    lam_fn = lambda f: jmf.lambda_from_damped_freq(f, 6.0, 1e-7)
    lt, wt = tmf.assign_targets(fd, peaks, pw, SR, 0.06, lam_fn)
    lj, wj = jmf.assign_targets(fd, peaks, pw, SR, 0.06, lam_fn)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(wt, wj)
    for a, b in zip(tmf._scale_scan(fd, peaks, pw, SR, 0.06),
                    jmf._scale_scan(fd, peaks, pw, SR, 0.06)):
        np.testing.assert_array_equal(a, b)
    assert tmf.scale_align(fd, peaks, pw, SR, 0.06) == jmf.scale_align(fd, peaks, pw, SR, 0.06)
    # scaled predictions: several candidate scales, best first
    for c in (0.3, 1.0, 4.0):
        got = tmf.scale_align_candidates(fd * c, peaks, pw, SR, 0.06)
        assert got == jmf.scale_align_candidates(fd * c, peaks, pw, SR, 0.06)
        assert 1 <= len(got) <= 3


def test_fitter_refuses_an_empty_peak_set():
    with pytest.raises(ValueError, match="no spectral peaks"):
        tmf.ModalNewtonFitter(None, np.zeros(0), np.zeros(0), SR, 6.0, 1e-7)


@pytest.fixture(scope="module")
def small_cube():
    """tests/test_modal_fit.py's setup: GT audio at an unknown material on a
    small cube, the fit cold-started at a 40%-off material."""
    mesh = cube_tet_mesh(3, size=0.4)
    sr, T, modes = SR, 6000, 10
    gt = (2700.0, 6.1e10, 0.31, 6.0, 1e-7)
    init = (2700.0, 3.7e10, 0.15, 6.0, 1e-7)
    gt_model = jbuild(mesh=mesh, mode_num=modes, order=1, mat=gt, task="gt",
                      dtype=jnp.float64)
    eig = gt_model.eigen_decomposition(method="arpack", sigma=1e6)
    osc = JOsc(1, modes, T, sr, JMaterial.of(gt))
    audio, _ = osc(gt_model.get_undamped_freqs({}, eig), jnp.zeros((1, 50)).at[0, 0].set(1.0),
                   dtype=jnp.float64)
    peaks, wts = extract_spectral_peaks(np.asarray(audio), sr)
    return dict(mesh=mesh, modes=modes, gt=gt, init=init, peaks=peaks, wts=wts)


def test_newton_fit_matches_jax_and_recovers_material(small_cube):
    c = small_cube
    mu0, lam0 = (float(x) for x in lame_params(c["init"][1] / c["init"][0], c["init"][2]))
    jm = jbuild(mesh=c["mesh"], mode_num=c["modes"], order=1, mat=c["init"],
                task="material", dtype=jnp.float64)
    rj = jmf.ModalNewtonFitter(jm, c["peaks"], c["wts"], SR, 6.0, 1e-7).fit(mu0, lam0, rounds=15)
    tm = build_model(mesh=c["mesh"], mode_num=c["modes"], order=1, mat=c["init"],
                     task="material", device="cpu")
    fitter = tmf.ModalNewtonFitter(tm, c["peaks"], c["wts"], SR, 6.0, 1e-7)
    rt = fitter.fit(mu0, lam0, rounds=15)
    np.testing.assert_allclose(rt["E"], rj["E"], rtol=1e-6)
    np.testing.assert_allclose(rt["nu"], rj["nu"], rtol=1e-6)
    assert len(rt["history"]) == len(rj["history"])
    assert abs(rt["E"] - c["gt"][1]) / c["gt"][1] < 0.02
    assert abs(rt["nu"] - c["gt"][2]) < 0.03
    # one cold host solve, then warm LOBPCG solves, each recorded
    assert [s["warm"] for s in fitter.solves] == [False] + [True] * (len(fitter.solves) - 1)
    assert all(s["iterations"] > 0 for s in fitter.solves[1:])
    assert isinstance(rt["eig"].eigenvectors, torch.Tensor)


def test_eigensolve_options_match_jax():
    """The cold eigen_decomposition and eigen_decomposition_at_lame's warm
    branch, against the JAX package and host ARPACK."""
    mesh, mat = cube_tet_mesh(2, 0.5), (2700, 7.2e10, 0.19, 6, 1e-7)
    jm = jbuild(mesh=mesh, mode_num=6, order=1, mat=mat, task="material", dtype=jnp.float64)
    tm = build_model(mesh=mesh, mode_num=6, order=1, mat=mat, task="material", device="cpu")
    cold_j = jm.eigen_decomposition(method="arpack")
    cold_t = tm.eigen_decomposition()
    np.testing.assert_allclose(cold_t.eigenvalues[6:].numpy(),
                               np.asarray(cold_j.eigenvalues)[6:], rtol=1e-10)
    # warm from the same eigenvectors at a 5%-moved material
    mu, lam = (1.05 * float(x) for x in lame_params(mat[1] / mat[0], mat[2]))
    prev = eigen_state_from_numpy(np.asarray(cold_j.eigenvalues),
                                  np.asarray(cold_j.eigenvectors), torch.float64)
    warm_j = jm.eigen_decomposition_at_lame(mu, lam, prev=cold_j)
    warm_t = tm.eigen_decomposition_at_lame(mu, lam, prev=prev)
    assert warm_t.iterations > 0
    np.testing.assert_allclose(warm_t.eigenvalues[6:].numpy(),
                               np.asarray(warm_j.eigenvalues)[6:], rtol=1e-10)
    np.testing.assert_allclose(warm_t.eigenvalues[6:].numpy(),
                               1.05 * cold_t.eigenvalues[6:].numpy(), rtol=1e-10)
