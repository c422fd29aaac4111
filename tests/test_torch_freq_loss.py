"""Parity of the port's spectral-peak matching (audio/freq_loss.py) and
damping curve (audio/damping.py) with the JAX package, in f64: the host-side
peak extraction, union and coverage score for every window scheme the
modal-Newton recipe uses, and the Nyquist fold and soft-Chamfer loss, value
and gradient, with modes above Nyquist."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import damping as jdamp
from diffsound_tpu.audio import freq_loss as jfl

from diffsound_torch.audio import damping as tdamp
from diffsound_torch.audio import freq_loss as tfl

torch.set_num_threads(2)

SR = 32000.0
SCHEMES = [("hann", 4096), ("blackmanharris", 4096), ("blackmanharris", None),
           ("blackmanharris", 1024)]


def _modal_audio(A=1, T=8000, M=12, seed=0):
    """Decaying modes, a few of them above Nyquist (they alias)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(T) + 1) / SR
    f = np.concatenate([rng.uniform(300, 15000, M - 3), rng.uniform(16500, 30000, 3)])
    d = 0.5 * (6.0 + 1e-7 * (2 * np.pi * f) ** 2)
    amp = rng.uniform(0.2, 1.0, (A, M))
    x = (amp[:, :, None] * np.exp(-d[:, None] * t) * np.sin(2 * np.pi * f[:, None] * t)).sum(1)
    return x, f


@pytest.mark.parametrize("window,n_fft", SCHEMES)
@pytest.mark.parametrize("A", [1, 3])
def test_peak_extraction_matches_jax(window, n_fft, A):
    x, _ = _modal_audio(A=A, seed=A)
    pj, wj = jfl.extract_spectral_peaks(x, SR, n_fft=n_fft, window=window)
    pt, wt = tfl.extract_spectral_peaks(x, SR, n_fft=n_fft, window=window)
    assert len(pt) == len(pj) > 4
    np.testing.assert_allclose(pt, pj, rtol=1e-12)
    np.testing.assert_allclose(wt, wj, rtol=1e-12)


def test_union_and_coverage_match_jax():
    x, f = _modal_audio(seed=7)
    sets = [jfl.extract_spectral_peaks(x, SR, n_fft=n, window=w) for w, n in SCHEMES[:3]]
    uj, vj = jfl.union_peaks(sets)
    ut, vt = tfl.union_peaks(sets)
    assert len(ut) == len(uj) < sum(len(s[0]) for s in sets)  # duplicates merged
    np.testing.assert_allclose(ut, uj, rtol=1e-12)
    np.testing.assert_allclose(vt, vj, rtol=1e-12)
    empty_j, empty_t = jfl.union_peaks([]), tfl.union_peaks([])
    assert empty_j[0].shape == empty_t[0].shape == (0,)
    # predictions at the true (damped ~ undamped here) and at a 3% offset
    for pred in (f, 1.03 * f):
        sj = jfl.peak_coverage_score(pred, uj, vj, SR)
        st = tfl.peak_coverage_score(pred, ut, vt, SR)
        np.testing.assert_allclose(st, sj, rtol=1e-12)
    assert tfl.peak_coverage_score(f, ut, vt, SR) > tfl.peak_coverage_score(1.03 * f, ut, vt, SR)


def test_silence_gives_no_peaks():
    pt, wt = tfl.extract_spectral_peaks(np.zeros(4000), SR)
    pj, _ = jfl.extract_spectral_peaks(np.zeros(4000), SR)
    assert pt.shape == pj.shape


def test_fold_nyquist_value_and_grad():
    # below Nyquist, above it, past sr, exactly at sr (r = 0: gradient 0)
    f = np.array([440.0, 15999.0, 17000.0, 31000.0, 33000.0, 47000.0, SR, 2 * SR + 5.0])
    w = np.random.default_rng(1).standard_normal(f.shape)
    oj, vjp = jax.vjp(lambda x: jfl.fold_nyquist(x, SR), jnp.asarray(f))
    ft = torch.as_tensor(f).requires_grad_(True)
    ot = tfl.fold_nyquist(ft, SR)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), rtol=1e-10)
    (gt,) = torch.autograd.grad(ot, ft, torch.as_tensor(w))
    np.testing.assert_allclose(gt.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-10)
    assert gt[6] == 0.0


@pytest.mark.parametrize("fold", [True, False])
def test_freq_chamfer_value_and_grad(fold):
    x, f = _modal_audio(seed=3)
    pk, pw = jfl.extract_spectral_peaks(x, SR)
    # predictions 2% off the truth, with the above-Nyquist modes kept, and
    # one mode under the 20 Hz floor (its gradient is cut by the floor)
    pred = np.concatenate([1.02 * f, [12.0]])
    vj, gj = jax.value_and_grad(
        lambda p: jfl.freq_chamfer_loss(p, jnp.asarray(pk), jnp.asarray(pw), SR, fold=fold)
    )(jnp.asarray(pred))
    pt = torch.as_tensor(pred).requires_grad_(True)
    vt = tfl.freq_chamfer_loss(pt, torch.as_tensor(pk), pw, SR, fold=fold)
    (gt,) = torch.autograd.grad(vt, pt)
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-10)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10 * np.abs(gj).max())
    assert gt[-1] == 0.0


def test_damping_curve_matches_jax():
    rng = np.random.default_rng(5)
    freqs = rng.uniform(50, 19000, 60)
    damps = rng.uniform(1, 400, 60)
    cj, ct = jdamp.DampingCurve(freqs, damps), tdamp.DampingCurve(freqs, damps)
    np.testing.assert_array_equal(ct.x, cj.x)
    np.testing.assert_array_equal(ct.y, cj.y)
    q = np.linspace(0, 25000, 101)
    np.testing.assert_array_equal(ct(q), np.asarray(cj(q)))
    with pytest.raises(ValueError):
        tdamp.DampingCurve([100.0], [5.0])
