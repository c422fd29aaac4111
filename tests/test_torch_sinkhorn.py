"""Parity of the port's Sinkhorn recipe with the JAX package, in f64: the
debiased Sinkhorn divergence (audio/sinkhorn.py) batched and with n != m,
spec_to_points with colliding modes, and MSSLoss's `geomloss` branch, values
and gradients.  The JAX package's own float32 gap for the same step, which
gates the card's, is tests/test_torch_geomloss_f32.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import mss_loss as jmss
from diffsound_tpu.audio import oscillator as josc
from diffsound_tpu.audio import sinkhorn as jsk
from diffsound_tpu.fem.material import Material as JMaterial

from diffsound_torch.audio import mss_loss as tmss
from diffsound_torch.audio import sinkhorn as tsk

torch.set_num_threads(2)

SR = 32000.0
MAT = (2700, 7.2e10, 0.19, 6, 1e-7)


def _clouds(B, n, m, seed):
    """Point clouds shaped like spec_to_points': three features spanning a
    few decades and a position in [0, 1)."""
    rng = np.random.default_rng(seed)
    def cloud(k):
        feats = rng.lognormal(0.0, 1.5, (B, k, 3))
        return np.concatenate([feats, rng.uniform(0, 1, (B, k, 1))], axis=-1)
    return cloud(n), cloud(m)


@pytest.mark.parametrize("B,n,m", [(1, 40, 40), (3, 33, 57)])
def test_sinkhorn_divergence_value_and_grads(B, n, m):
    x, y = _clouds(B, n, m, seed=n + m)
    w = np.random.default_rng(1).standard_normal(B)
    div_j = jax.jit(jax.vmap(jsk.sinkhorn_divergence))
    vj, vjp = jax.vjp(div_j, jnp.asarray(x), jnp.asarray(y))
    xt, yt = (torch.as_tensor(a).requires_grad_(True) for a in (x, y))
    vt = tsk.sinkhorn_divergence(xt, yt)
    assert vt.shape == (B,)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=1e-9)
    gx, gy = torch.autograd.grad(vt, (xt, yt), torch.as_tensor(w))
    jx, jy = vjp(jnp.asarray(w))
    for g, j in ((gx, jx), (gy, jy)):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-9, atol=1e-9 * np.abs(j).max())


def test_sinkhorn_divergence_of_a_cloud_with_itself_is_zero():
    x, _ = _clouds(2, 30, 30, seed=4)
    xt = torch.as_tensor(x)
    d = tsk.sinkhorn_divergence(xt, xt)
    assert float(d.abs().max()) < 1e-8 * float(tsk.sinkhorn_divergence(xt, xt.flip(1) + 1.0).min())


# F = 129 bins (n_fft 256) up to 16 kHz: 1000 and 1005 Hz share bin 8; 15900 Hz
# is in the last bin, and 17000 Hz lies above Nyquist, clipped onto that bin
# with its write masked off; 20 Hz puts its lower neighbours below bin 0.
COLLIDING = [
    [1000.0, 1005.0, 15900.0, 17000.0, 20.0, 4000.0],
    [1005.0, 1000.0, 17000.0, 15900.0, 4000.0, 20.0],
]


@pytest.mark.parametrize("freqs", COLLIDING)
def test_spec_to_points_collisions_match_jax(freqs):
    rng = np.random.default_rng(2)
    spec = rng.uniform(0, 5, (2, 129, 9))
    f = np.asarray(freqs)
    w = rng.standard_normal((2, 129, 4))
    pj, vjp = jax.vjp(lambda fr: jmss.spec_to_points(jnp.asarray(spec), fr, SR), jnp.asarray(f))
    ft = torch.as_tensor(f).requires_grad_(True)
    pt = tmss.spec_to_points(torch.as_tensor(spec), ft, SR)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-12, atol=0)
    (gt,) = torch.autograd.grad(pt, ft, torch.as_tensor(w))
    np.testing.assert_allclose(gt.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-12)
    # deterministic: a second call is bit for bit the first
    assert torch.equal(tmss.spec_to_points(torch.as_tensor(spec), ft, SR), pt)
    # without frequencies the positions are the bins' own
    plain = tmss.spec_to_points(torch.as_tensor(spec))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jmss.spec_to_points(jnp.asarray(spec))),
                               rtol=1e-12)


def _modal_pair(T, seed, dtype=np.float64):
    """Target audio from 16 modes, and a prediction's undamped frequencies
    5% above the target's (the early phase's situation)."""
    rng = np.random.default_rng(seed)
    f_tgt = np.sort(rng.uniform(400, 14000, 16)).astype(dtype)
    return f_tgt, (1.05 * f_tgt).astype(dtype)


@functools.lru_cache(maxsize=None)
def _jitted_loss(loss):
    return jax.jit(lambda sig, damped, tc: loss(sig, None, damped, 1.0, target_cache=tc))


def _jax_geomloss(n_ffts, T, f_tgt, f_pred, dtype):
    """The JAX package's geomloss step: value and gradient to the undamped
    frequencies.  The synthesis and the target side run op by op and only
    the loss is one compiled program: XLA's fused synthesis under jit moves
    the signal by a few ulps, and this step's gradient amplifies an ulp in
    the spectrogram features about 1e7-fold (at eps = blur^2 = 1e-4 the
    linear-spectrum costs C / eps reach 1e7), so the fully jitted step sits
    7.5e-6 (gradient, relative to its largest entry) and 9.5e-9 (loss) from
    this one at n_fft 256/128 and T = 2000, while the port agrees with this
    one to 1.1e-11."""
    osc = josc.TraditionalOscillatorParams(1, len(f_tgt), T, SR, JMaterial.of(MAT))
    forces = jnp.zeros((1, 150), dtype).at[0, 0].set(1.0)
    target, _ = osc(jnp.asarray(f_tgt, dtype), forces, dtype=dtype)
    loss = jmss.MSSLoss(tuple(n_ffts), SR, loss_type="geomloss")
    tc = loss.target_cache(target)

    def fn(fp):
        sig, damped = osc(fp, forces, dtype=dtype)
        return _jitted_loss(loss)(sig, damped, tc)

    v, g = jax.value_and_grad(fn)(jnp.asarray(f_pred, dtype))
    return float(v), np.asarray(g, np.float64), np.asarray(target)


def test_mss_geomloss_value_and_grad():
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.fem.material import Material

    n_ffts, T = [256, 128], 2000
    f_tgt, f_pred = _modal_pair(T, seed=3)
    vj, gj, target = _jax_geomloss(n_ffts, T, f_tgt, f_pred, jnp.float64)

    osc = TraditionalOscillatorParams(1, 16, T, SR, Material.of(MAT))
    forces = torch.zeros((1, 150), dtype=torch.float64)
    forces[0, 0] = 1.0
    loss = tmss.MSSLoss(n_ffts, SR, loss_type="geomloss")
    tc = loss.target_cache(torch.as_tensor(target))
    fp = torch.as_tensor(f_pred).requires_grad_(True)
    sig, damped = osc(fp, forces, dtype=torch.float64)
    vt = loss(sig, None, damped, 1.0, target_cache=tc)
    (gt,) = torch.autograd.grad(vt, fp)
    np.testing.assert_allclose(vt.item(), vj, rtol=1e-8)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-8, atol=1e-8 * np.abs(gj).max())
    # the cache gives the same loss as recomputing the target side
    with torch.no_grad():
        sig, damped = osc(fp, forces, dtype=torch.float64)
        assert loss(sig, torch.as_tensor(target), damped, 1.0).item() == vt.item()


def test_logsumexp_gradient_holds_at_sinkhorn_magnitudes_in_float32():
    """At eps = blur^2 the Sinkhorn's softmin arguments reach |C| / eps ~
    1e14; the gradient must still be the softmax, as JAX's logsumexp gives
    it.  torch.logsumexp's backward, exp(x - result), loses it in float32
    (the result is off by up to half an ulp of 1e14, about 4e6)."""
    rng = np.random.default_rng(8)
    x64 = -1e14 + rng.uniform(0, 30, (2, 50))
    x32 = torch.tensor(x64, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(tsk._logsumexp(x32, 1).sum(), x32)
    x = x32.detach().double()  # the float32 inputs, exactly
    want = torch.softmax(x, dim=1)
    np.testing.assert_allclose(g.double().numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tsk._logsumexp(x, 1).numpy(), torch.logsumexp(x, 1).numpy(),
                               rtol=1e-15)
    (g_torch,) = torch.autograd.grad(torch.logsumexp(x32, 1).sum(), x32)
    assert float((g_torch.double() - want).abs().max()) > 0.1  # why _logsumexp exists


@pytest.mark.parametrize("n_fft", [2048, 1024])
def test_sinkhorn_float32_gap_on_linear_spectrum_points(n_fft):
    """The geomloss linear-spectrum clouds (features up to 4e2, squared
    diameter 2e5), rounded to float32 once (chip_smoke.lin_clouds), then the
    divergence in float32 against float64 on those same inputs.  The gate is
    computed here from the JAX package: 4 times the larger of its gap at
    seed 11 and its median gap over seeds 11-20 (a seed's gap is one draw of
    float32's rounding of potentials near 3e5; JAX's spans 8e-8 to 6.7e-6),
    and chip_smoke.py holds the card to the same gates.  Readings at seed 11
    and n_fft 2048 / 1024: the port 1.88e-6 / 1.53e-6 with its exp-sums in
    float64, 3.96e-6 / 3.03e-6 summed in float32 (above the gates 2.71e-6 /
    2.44e-6), 2.3e-4 at 1024 reduced over a strided transpose of the cost
    (the self problems' g drifted an ulp from f); JAX 2.0e-7 / 3.5e-8."""
    import chip_smoke

    jitted = jax.jit(jsk.sinkhorn_divergence)
    jax_gaps = {}
    for seed in chip_smoke.GEOMLOSS_SEEDS:
        x, y = chip_smoke.lin_clouds(seed, n_fft)
        xj, yj = jnp.asarray(x[0].numpy()), jnp.asarray(y[0].numpy())
        jax_gaps[seed] = abs(float(jitted(xj, yj))
                             / float(jitted(xj.astype(jnp.float64), yj.astype(jnp.float64))) - 1)
    seed = chip_smoke.GEOMLOSS_SEEDS[0]
    gate = chip_smoke.sinkhorn_f32_gate(n_fft, seed, jax_gaps)
    # the card's gates are JAX's readings here, stored
    assert chip_smoke.sinkhorn_f32_gate(n_fft, seed) == pytest.approx(gate, rel=0.05)
    x, y = chip_smoke.lin_clouds(seed, n_fft)
    v32 = tsk.sinkhorn_divergence(x, y).item()
    v64 = tsk.sinkhorn_divergence(x.double(), y.double()).item()
    print(f"float32 Sinkhorn divergence gap at n_fft {n_fft}, seed {seed}: port "
          f"{abs(v32 / v64 - 1):.3e}, JAX {jax_gaps[seed]:.3e}, gate {gate:.3e}")
    assert abs(v32 / v64 - 1) <= gate


def test_geomloss_log_points_are_float64_like_jax():
    """The JAX package's log spectrum subtracts a numpy float64 constant,
    which promotes it to float64 under x64; the port's log points follow,
    from float32 audio as from float64."""
    x = _modal_pair(2000, seed=1)[0]
    t = np.sin(2 * np.pi * x[:, None] * np.arange(2000) / SR).sum(0)[None]
    tc_j = jmss.SSSLoss(256, SR, loss_type="geomloss").target_cache(jnp.asarray(t, jnp.float32))
    tc_t = tmss.SSSLoss(256, SR, loss_type="geomloss").target_cache(
        torch.as_tensor(t, dtype=torch.float32))
    assert tc_j[0].dtype == jnp.float64 and tc_t[0].dtype == torch.float64
    # the float32 spectra of the two FFTs differ in their last bits, which
    # the log of the quiet bins turns into up to 3.2e-5 here
    np.testing.assert_allclose(tc_t[0].numpy(), np.asarray(tc_j[0]), rtol=0, atol=1e-4)
