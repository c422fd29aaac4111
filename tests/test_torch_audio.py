"""Parity of the port's audio layer (spectrogram, force convolution, MSS
losses) with the JAX package, in f64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import mss_loss as jmss
from diffsound_tpu.audio import oscillator as josc
from diffsound_tpu.audio import stft as jstft

from diffsound_torch.audio import mss_loss as tmss
from diffsound_torch.audio import oscillator as tosc
from diffsound_torch.audio import stft as tstft

torch.set_num_threads(2)

RTOL = 1e-10


def _signal(A=2, T=2000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 32000.0
    f = rng.uniform(200, 6000, (A, 5, 1))
    x = (np.sin(2 * np.pi * f * t) * np.exp(-30 * t)).sum(1)
    return x + 1e-3 * rng.standard_normal((A, T))


@pytest.mark.parametrize("n_fft", [64, 256, 1024])
def test_spectrogram_value_and_grad(n_fft):
    x = _signal()
    hop = n_fft // 4
    w = np.random.default_rng(1).standard_normal(
        np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft, hop)).shape
    )
    sj, vjp = jax.vjp(jax.jit(lambda y: jstft.spectrogram(y, n_fft, hop)), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    st = tstft.spectrogram(xt, n_fft, hop)
    assert st.shape == sj.shape
    sj = np.asarray(sj)
    np.testing.assert_allclose(st.detach().numpy(), sj, rtol=RTOL, atol=RTOL * sj.max())
    (gt,) = torch.autograd.grad(st, xt, torch.as_tensor(w))
    gj = np.asarray(vjp(jnp.asarray(w))[0])
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=RTOL * np.abs(gj).max())


def test_fft_convolve_force_value_and_grad():
    rng = np.random.default_rng(2)
    sig, forces = rng.standard_normal((2, 1000)), rng.standard_normal((2, 150))
    w = rng.standard_normal((2, 1000))
    oj, vjp = jax.vjp(josc.fft_convolve_force, jnp.asarray(sig), jnp.asarray(forces))
    st = torch.as_tensor(sig).requires_grad_(True)
    ft = torch.as_tensor(forces).requires_grad_(True)
    ot = tosc.fft_convolve_force(st, ft)
    oj = np.asarray(oj)
    np.testing.assert_allclose(ot.detach().numpy(), oj, rtol=RTOL, atol=RTOL * np.abs(oj).max())
    # direct causal convolution
    ref = np.stack([np.convolve(sig[a], forces[a])[:1000] for a in range(2)])
    np.testing.assert_allclose(ot.detach().numpy(), ref, rtol=1e-10, atol=1e-10)
    gs, gf = torch.autograd.grad(ot, (st, ft), torch.as_tensor(w))
    js, jf = vjp(jnp.asarray(w))
    np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jf), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("loss_type", ["l1_loss", "rmse_loss"])
def test_mss_loss_with_target_cache(loss_type):
    n_ffts = [1024, 512, 256, 128, 64]
    x_true, x_pred = _signal(1, 2000, 3), _signal(1, 2000, 4)
    lj = jmss.MSSLoss(n_ffts, 32000.0, loss_type=loss_type)
    lt = tmss.MSSLoss(n_ffts, 32000.0, loss_type=loss_type)
    tc_j = jax.jit(lj.target_cache)(jnp.asarray(x_true))
    # one compiled program: op by op, JAX compiles each of the loss's many
    # small ops on its own, which takes five times longer
    vj, gj = jax.jit(jax.value_and_grad(
        lambda p, tc: lj(p, None, None, 1.0, target_cache=tc)))(jnp.asarray(x_pred), tc_j)
    tc_t = lt.target_cache(torch.as_tensor(x_true))
    xp = torch.as_tensor(x_pred).requires_grad_(True)
    vt = lt(xp, None, None, 1.0, target_cache=tc_t)
    (gt,) = torch.autograd.grad(vt, xp)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-9)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-9, atol=1e-9 * np.abs(gj).max())
    # the cache gives the same loss as recomputing the target side
    v_nocache = lt(xp, torch.as_tensor(x_true))
    assert float(v_nocache) == float(vt)


def test_geomloss_names_its_roadmap_item():
    """The Sinkhorn item of the roadmap is done: `geomloss` builds and
    scores (its parity is tests/test_torch_sinkhorn.py), and only a loss
    type that does not exist raises."""
    loss = tmss.MSSLoss([256, 128], 32000.0, loss_type="geomloss")
    x = torch.as_tensor(_signal(1, 2000, 5))
    value = loss(x, torch.as_tensor(_signal(1, 2000, 6)), torch.tensor([440.0, 3000.0]), 1.0)
    assert torch.isfinite(value)
    with pytest.raises(ValueError, match="unknown loss type"):
        tmss.MSSLoss([256], 32000.0, loss_type="emd")(x, x)
