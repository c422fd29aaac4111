"""The oscillator-synthesis kernel module (diffsound_torch.audio.synth_kernel):
its plain version against the JAX package's XLA path and Pallas kernel (in
interpret mode), SynthFn's backward against jax.grad of synth_fused, and
the CPU/CUDA dispatch.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import pallas_osc
from diffsound_tpu.audio.oscillator import _synth_constant_modes_xla

from diffsound_torch.audio import synth_kernel
from diffsound_torch.audio.oscillator import synth_constant_modes
from diffsound_torch.audio.synth_kernel import SynthFn, synth_constant_modes_plain

torch.set_num_threads(2)

SR = 32000.0


def _modes(A, M, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(100, 8000, (A, M)).astype(dtype),
        rng.uniform(1, 100, (A, M)).astype(dtype),
        rng.uniform(0.1, 1, (A, M)).astype(dtype),
    )


def test_plain_matches_xla_and_pallas_interpreted():
    A, M, T = 2, 16, 1000
    f, d, a = _modes(A, M)
    ref_xla = np.asarray(_synth_constant_modes_xla(*map(jnp.asarray, (f, d, a)), T, SR))
    ref_pallas = np.asarray(
        pallas_osc.pallas_synth(*map(jnp.asarray, (f, d, a)), T, SR, block_t=256,
                                interpret=True)
    )
    out = synth_constant_modes_plain(*map(torch.as_tensor, (f, d, a)), T, SR).numpy()
    assert out.shape == (A, T) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_xla, atol=5e-5)
    np.testing.assert_allclose(out, ref_pallas, atol=5e-5)


def test_plain_matches_xla_f64():
    f, d, a = _modes(3, 40, np.float64, seed=1)
    ref = np.asarray(_synth_constant_modes_xla(*map(jnp.asarray, (f, d, a)), 1000, SR))
    out = synth_constant_modes_plain(*map(torch.as_tensor, (f, d, a)), 1000, SR).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-12)


def test_synthfn_cpu_backward_matches_jax_grad_of_synth_fused():
    A, M, T = 2, 16, 1000
    f, d, a = _modes(A, M, seed=2)
    f = (f * 0.5).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((A, T)).astype(np.float32)

    def loss_j(f, d, a):
        return jnp.sum(pallas_osc.synth_fused(f, d, a, T, SR) * w)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (f, d, a)))
    ts = [torch.as_tensor(x).requires_grad_(True) for x in (f, d, a)]
    before = synth_kernel.LAUNCHES
    out = SynthFn.apply(*ts, T, SR)
    gt = torch.autograd.grad((out * torch.as_tensor(w)).sum(), ts)
    assert synth_kernel.LAUNCHES == before  # CPU tensors never reach the kernel
    for g_t, g_j in zip(gt, gj):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=5e-5 * np.abs(g_j).max())


def test_dispatch_cpu_uses_plain_version():
    f, d, a = map(torch.as_tensor, _modes(1, 8))
    forces = torch.zeros(1, 20)
    forces[0, 0] = 1.0
    before = synth_kernel.LAUNCHES
    out = synth_constant_modes(f, d, a, 500, SR, forces)
    assert synth_kernel.LAUNCHES == before
    np.testing.assert_allclose(
        out.numpy(), synth_constant_modes_plain(f, d, a, 500, SR).numpy(), atol=1e-6
    )


def test_wrapper_on_cpu_is_the_plain_version():
    f, d, a = map(torch.as_tensor, _modes(3, 40, seed=4))
    np.testing.assert_array_equal(
        synth_kernel.synth_kernel(f, d, a, 1000, SR).numpy(),
        synth_constant_modes_plain(f, d, a, 1000, SR).numpy(),
    )
