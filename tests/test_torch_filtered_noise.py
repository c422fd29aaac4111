"""The port's FilteredNoise against the JAX package's, in float64: the white
noise is drawn in the test with the JAX package's own expression and key and
handed to the port, then the values and the gradient to `coeff_bank` are
compared (tolerance 1e-12 absolute on values of order 1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio.filtered_noise import FilteredNoise as JFilteredNoise

from diffsound_torch.audio.filtered_noise import FilteredNoise

torch.set_num_threads(2)


def _jax_noise(fn, key, dtype=jnp.float64):
    """The white noise JAX's FilteredNoise.__call__ draws from `key`."""
    shape = (fn.noise_num, fn.frame_num, fn.frame_length)
    return np.asarray(jax.random.uniform(key, shape, dtype) * 2.0 - 1.0)


@pytest.mark.parametrize("kw", [
    dict(noise_num=3, sample_num=500),
    dict(noise_num=2, sample_num=8000),
    # out_len 16 + 65 - 1 = 80: five hops
    dict(noise_num=2, sample_num=300, filter_coeff_length=33, frame_length=16),
    # out_len 64 + 79 - 1 = 142: not a whole number of hops
    dict(noise_num=1, sample_num=700, filter_coeff_length=40, attenuate_gain=0.5),
])
def test_filtered_noise_matches_jax(kw):
    jf, tf = JFilteredNoise(**kw), FilteredNoise(**kw)
    params = jf.init_params(jax.random.PRNGKey(0), jnp.float64)
    key = jax.random.PRNGKey(7)
    w = np.random.default_rng(1).normal(size=(kw["noise_num"], kw["sample_num"]))

    # one compiled program: op by op JAX takes seconds a call
    out_j, vjp = jax.vjp(jax.jit(lambda c: jf({"coeff_bank": c}, key)), params["coeff_bank"])
    out_j = np.asarray(out_j)
    grad_j = np.asarray(vjp(jnp.asarray(w))[0])

    cb = torch.tensor(np.asarray(params["coeff_bank"])).requires_grad_(True)
    out_t = tf({"coeff_bank": cb}, noise=torch.as_tensor(_jax_noise(jf, key)))
    (out_t * torch.as_tensor(w)).sum().backward()

    assert out_t.shape == out_j.shape == (kw["noise_num"], kw["sample_num"])
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cb.grad.numpy(), grad_j, rtol=0, atol=1e-12)


def test_irfft_of_the_real_half_spectrum_and_the_window_match_jax():
    """torch.fft.irfft of a real half-spectrum (n = 129, odd) against
    jnp.fft.irfft of its complex cast, with the gradient; the symmetric
    Hann window against np.hanning."""
    x = np.random.default_rng(2).uniform(0.1, 2.0, (4, 65))
    w = np.random.default_rng(3).normal(size=(4, 129))
    f_j = lambda v: jnp.fft.irfft(v.astype(jnp.complex128), n=129, axis=-1)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = torch.fft.irfft(xt, n=129, dim=-1)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(f_j(jnp.asarray(x))),
                               rtol=0, atol=1e-15)
    g_j = jax.grad(lambda v: jnp.sum(f_j(v) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=0, atol=1e-14)
    win = torch.hann_window(129, periodic=False, dtype=torch.float64).numpy()
    np.testing.assert_allclose(win, np.hanning(129), rtol=0, atol=1e-15)


def test_noise_draws_come_from_the_generator():
    """Noise from a generator: the same seed gives the same signal, another
    seed another; the draw is U[-1, 1) frames of the declared shape; no
    generator means one seeded 0."""
    fn = FilteredNoise(2, 1000)
    params = fn.init_params(torch.Generator().manual_seed(0), torch.float64)
    assert params["coeff_bank"].shape == (2, fn.frame_num, 65)
    a = fn(params, torch.Generator().manual_seed(4))
    b = fn(params, torch.Generator().manual_seed(4))
    c = fn(params, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.equal(fn(params), fn(params, torch.Generator().manual_seed(0)))
    noise = fn.white_noise(torch.Generator().manual_seed(4), torch.float64)
    assert noise.shape == (2, fn.frame_num, 64)
    assert float(noise.min()) >= -1.0 and float(noise.max()) < 1.0
    assert torch.equal(fn(params, noise=noise), a)
