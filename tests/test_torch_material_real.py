"""Stage 1 of the port's material_real task against the JAX package on the
CPU: the GT-oscillator fit (`fit_gt_oscillator`) and the damping-curve
extraction.  Stage 2 is in tests/test_torch_material_real_stage2.py, the
CLI in tests/test_torch_material_real_cli.py.

Stage 1 in float64: JAX's `fit_gt_oscillator` draws its params in float32,
so its f64 steps are built here from the JAX package's own pieces as that
function builds them (GTOscillatorBank, a 5-scale L1 MSSLoss, Adam with the
step-decayed rate), run op by op as the synthesis comparison needs (see
tests/test_torch_material_real_bank.py).  optax evaluates the learning-rate
schedule in float32, so the port is handed that float32 rate (LR32): 5e-3
against its float32 rounding parts the two trajectories by 2e-8 relative
a step, which Adam's per-parameter scaling then grows.  The packages'
noise streams differ (split PRNG keys against a torch.Generator), so stage
1 is compared without noise, and for one step with JAX's draw handed to the
port.
"""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import mss_loss as jmss
from diffsound_tpu.audio import oscillator as josc
from diffsound_tpu.experiments import material_real as jreal
from diffsound_tpu.fem.material import Material as JMaterial, MatSet as JMatSet

from diffsound_torch.experiments.material_real import extract_damping_curve, fit_gt_oscillator

torch.set_num_threads(2)

SR = 32000.0
LR32 = float(np.float32(5e-3))
CERAMIC = JMaterial.of(JMatSet.Ceramic)


def _recording(A=2, T=2000, seed=0):
    """A few damped modes per mic, float32-rounded as the JAX package
    rounds its targets."""
    rng = np.random.default_rng(seed)
    t = (np.arange(T) + 1) / SR
    f = rng.uniform(300, 9000, (A, 5, 1))
    d = rng.uniform(10, 80, (A, 5, 1))
    x = (rng.uniform(0.3, 1.0, (A, 5, 1)) * np.exp(-d * t) * np.sin(2 * np.pi * f * t)).sum(1)
    return (x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def _jax_stage1(gt, mode_num, init, iters, noise_rate=0.0, keys=None, lr=5e-3):
    """JAX's stage-1 loop (material_real.py's fit_gt_oscillator) in f64 from
    `init`: the loss of each step and the final params.  The bank runs op by
    op; the loss and the Adam update are compiled (their arithmetic is the
    same either way, and op by op they take seconds a step)."""
    A, T = gt.shape
    bank = josc.GTOscillatorBank(A, mode_num, T, SR, CERAMIC)
    loss_fn = jmss.MSSLoss([512, 256, 128, 64, 32], SR, loss_type="l1_loss")
    opt = optax.adam(optax.exponential_decay(lr, 100, 0.99, staircase=True))
    forces = jnp.zeros((A, 150), jnp.float64).at[:, 0].set(1.0)
    gt = jnp.asarray(gt, jnp.float64)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    state = opt.init(params)
    loss_of = jax.jit(lambda sig: loss_fn(sig, gt))
    update = jax.jit(opt.update)

    def lf(p, key):
        sig, _ = bank(p, forces, noise_rate=noise_rate, key=key)
        return loss_of(sig)

    losses = []
    for i in range(iters):
        loss, g = jax.value_and_grad(lf)(params, None if keys is None else keys[i])
        updates, state = update(g, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return np.asarray(losses), params


def _init(A, mode_num, T):
    bank = josc.GTOscillatorBank(A, mode_num, T, SR, CERAMIC)
    return jax.tree_util.tree_map(np.array,
                                  bank.init_params(jax.random.PRNGKey(0), jnp.float64))


def _assert_params_agree(got, want, atol):
    want = {**{k: v for k, v in want.items() if k != "noise"},
            "noise_coeff_bank": want["noise"]["coeff_bank"]}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0, atol=atol)


def test_fit_gt_oscillator_matches_jax_steps():
    """20 noise-free steps from JAX's draw: every step's loss within 1e-8
    relative, the params within 1e-6 of Adam's 20 steps of up to 5e-3 (the
    f64 gradients agree to rounding; Adam divides each parameter's step by
    its own gradient's scale, so the rounding of near-zero gradients grows
    to 2e-7 here)."""
    gt = _recording()
    init = _init(2, 16, gt.shape[1])
    want_losses, want = _jax_stage1(gt, 16, init, iters=20)
    forces = np.zeros((2, 150), np.float32)
    forces[:, 0] = 1.0
    bank, got, losses = fit_gt_oscillator(gt, forces, 16, SR, JMatSet.Ceramic, iters=20,
                                          lr=LR32, noise_rate=0.0, init_params=init,
                                          verbose=False, device="cpu")
    assert losses.shape == (20,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-8)
    _assert_params_agree(got, want, 1e-6)
    assert got["amp_raw"].dtype == torch.float64
    # the extracted damping curve: the JAX package's from the same fit
    curve = extract_damping_curve(bank, got)
    jbank = josc.GTOscillatorBank(2, 16, gt.shape[1], SR, CERAMIC)
    jcurve = jreal.extract_damping_curve(jbank, want)
    np.testing.assert_allclose(curve.x, jcurve.x, rtol=0, atol=0)
    np.testing.assert_allclose(curve.y, jcurve.y, rtol=1e-8)


def test_fit_gt_oscillator_one_step_with_jax_noise():
    """One step with filtered noise, the white noise JAX draws from its
    first split key handed to the port: loss within 1e-10 relative, params
    within 1e-10.  The noise moves the loss far beyond that."""
    gt = _recording(seed=1)
    init = _init(2, 16, gt.shape[1])
    rate = 1e-2
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    want_losses, want = _jax_stage1(gt, 16, init, iters=1, noise_rate=rate, keys=[sub])
    quiet_losses, _ = _jax_stage1(gt, 16, init, iters=1)
    frames = gt.shape[1] // 64 + 1
    noise = np.array(jax.random.uniform(sub, (2, frames, 64), jnp.float64) * 2.0 - 1.0)
    forces = np.zeros((2, 150), np.float32)
    forces[:, 0] = 1.0
    _, got, losses = fit_gt_oscillator(gt, forces, 16, SR, JMatSet.Ceramic, iters=1, noise_rate=rate,
                                       lr=LR32, init_params=init, noise=torch.as_tensor(noise)[None],
                                       verbose=False, device="cpu")
    assert abs(want_losses[0] / quiet_losses[0] - 1) > 1e-6
    np.testing.assert_allclose(losses, want_losses, rtol=1e-10)
    _assert_params_agree(got, want, 1e-10)


def test_fit_gt_oscillator_draws_its_own_noise_and_params():
    """Without init_params or noise: seeded draws, reproducible, finite, and
    a falling loss over 30 steps."""
    gt = _recording(seed=2)
    forces = np.zeros((2, 150), np.float32)
    forces[:, 0] = 1.0
    runs = [fit_gt_oscillator(gt, forces, 8, SR, JMatSet.Ceramic, iters=30, seed=3, verbose=False,
                              device="cpu") for _ in range(2)]
    (bank, p, losses), (_, p2, losses2) = runs
    assert np.isfinite(losses).all() and losses[-10:].mean() < losses[:10].mean()
    np.testing.assert_array_equal(losses, losses2)
    assert all(torch.equal(p[k], p2[k]) for k in p)
    assert p["freq_logits"].shape == (8, 2) and p["noise_coeff_bank"].shape == (2, 32, 65)
