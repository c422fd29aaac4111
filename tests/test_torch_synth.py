"""The oscillator-synthesis kernel module (diffsound_torch.audio.synth_kernel):
its plain versions, forward and backward, against the JAX package's XLA path
and Pallas kernel (in interpret mode), SynthFn's backward against jax.grad
of synth_fused, the CPU/CUDA dispatch, and a numpy mirror of the CUDA
kernels' block-factorised algebra, which shows that the gates the kernels
are held to on the card pass 3xTF32 and fail plain TF32.  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import pallas_osc
from diffsound_tpu.audio.oscillator import _synth_constant_modes_xla

from diffsound_torch.audio import synth_kernel
from diffsound_torch.audio.oscillator import synth_constant_modes
from diffsound_torch.audio.synth_kernel import (
    SynthFn, synth_constant_modes_bwd_plain, synth_constant_modes_plain,
)

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
    before = synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD
    out = SynthFn.apply(*ts, T, SR)
    gt = torch.autograd.grad((out * torch.as_tensor(w)).sum(), ts)
    # CPU tensors never reach the kernels
    assert (synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD) == before
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


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    f, d, a = map(torch.as_tensor, _modes(3, 40, seed=4))
    g = torch.as_tensor(np.random.default_rng(5).standard_normal((3, 1000)).astype(np.float32))
    before = synth_kernel.LAUNCHES_BWD
    got = synth_kernel.synth_kernel_bwd(f, d, a, g, 1000, SR)
    assert synth_kernel.LAUNCHES_BWD == before
    for x, y in zip(got, synth_constant_modes_bwd_plain(f, d, a, g, 1000, SR)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_bwd_plain_matches_jax_vjp_f64():
    A, M, T = 3, 40, 1000
    f, d, a = _modes(A, M, np.float64, seed=6)
    g = np.random.default_rng(7).standard_normal((A, T))
    _, vjp = jax.vjp(lambda *x: _synth_constant_modes_xla(*x, T, SR), *map(jnp.asarray, (f, d, a)))
    want = vjp(jnp.asarray(g))
    got = synth_constant_modes_bwd_plain(*map(torch.as_tensor, (f, d, a, g)), T, SR)
    for x, y in zip(got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-10, atol=1e-12 * np.abs(y).max())


# A numpy mirror of csrc/synth.cu's algebra: samples cut into rows of K,
# t + 1 = (n0 + 1) + k; seed phases reduced in f64; C and S from k = 8 j + i
# as one complex product of the oscillators at 8 j and i.  In float32 the
# factors are float32 and each product runs in TF32 (a 10-bit mantissa,
# rounded to nearest with ties away from zero, as cvt.rna.tf32) with float32
# sums: the 3xTF32 split of the kernels, or plain TF32.
#
# It does not stand in for the kernels, which tests/test_torch_cuda.py and
# chip_smoke.py hold against the plain versions on the card; it does not
# mirror the tensor cores' truncating accumulation or the kernels' tiling.
# It is kept for what the card cannot show, since only the 3xTF32 kernels
# exist there: that the gates those comparisons use (1e-5 sum|amp| forward,
# 1e-4 max|grad| backward) pass the 3xTF32 algebra with room to spare and
# fail the same algebra in plain TF32.  In float64 it checks the block
# factorisation itself against the direct sums.
K = 64


def _tf32(x):
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul(x, y, terms):
    """x @ y: in float64 exactly; in float32 with TF32 operands, the 3xTF32
    split (terms=3: lo*hi + hi*lo + hi*hi) or plain TF32 (terms=1)."""
    if x.dtype == np.float64:
        return x @ y
    xh, yh = _tf32(x), _tf32(y)
    if terms == 1:
        return xh @ yh
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return xl @ yh + xh @ yl + xh @ yh


def _oscillator(f, d, n, sr, dtype):
    """sin and cos of 2 pi frac(f n/sr) and e^{-d n/sr}, (A, M, len(n))."""
    cyc = f.astype(np.float64)[..., None] * (n.astype(np.float64) / sr)
    frac = cyc - np.floor(cyc)
    if dtype == np.float32:
        x = np.pi * (2 * frac).astype(np.float32).astype(np.float64)
        e = np.exp(-d[..., None] * (n.astype(np.float32) / np.float32(sr)))
        return np.sin(x).astype(np.float32), np.cos(x).astype(np.float32), e
    x = 2 * np.pi * frac
    return np.sin(x), np.cos(x), np.exp(-d[..., None] * (n / sr))


def _cs(f, d, sr, dtype):
    """C and S, (A, M, K): e^{-d k/sr} (cos, sin)(2 pi f k/sr)."""
    i = np.arange(8)
    s, c, e = _oscillator(f, d, i, sr, dtype)
    sj, cj, ej = _oscillator(f, d, 8 * i, sr, dtype)
    vx, vy = e * c, e * s  # at k = i
    ux, uy = (ej * cj)[..., :, None], (ej * sj)[..., :, None]  # at k = 8 j
    C = ux * vx[..., None, :] - uy * vy[..., None, :]
    S = uy * vx[..., None, :] + ux * vy[..., None, :]
    return C.reshape(*f.shape, K), S.reshape(*f.shape, K)


def _mirror_fwd(f, d, a, T, sr, dtype, terms=3):
    A, M = f.shape
    R = -(-T // K)
    s0, c0, e0 = _oscillator(f, d, np.arange(R) * K + 1, sr, dtype)
    ae = a[..., None] * e0
    pq = np.concatenate([ae * s0, ae * c0], axis=1).transpose(0, 2, 1)  # (A, R, 2M)
    cs = np.concatenate(_cs(f, d, sr, dtype), axis=1)  # (A, 2M, K)
    return _matmul(pq, cs, terms).reshape(A, R * K)[:, :T]


def _mirror_bwd(f, d, a, g, T, sr, dtype, terms=3):
    """The backward kernel's algebra: four products G C^T, G S^T, G (kC)^T,
    G (kS)^T, weighted by the row seeds and summed over rows."""
    A, M = f.shape
    R = -(-T // K)
    G = np.zeros((A, R * K), dtype)
    G[:, :T] = g
    G = G.reshape(A, R, K)
    n1 = np.arange(R) * K + 1
    s, c, e0 = _oscillator(f, d, n1, sr, dtype)
    s0, c0 = (e0 * s).transpose(0, 2, 1), (e0 * c).transpose(0, 2, 1)  # (A, R, M)
    C, S = _cs(f, d, sr, dtype)
    k = np.arange(K, dtype=dtype)
    gc, gs, gck, gsk = (_matmul(G, B.transpose(0, 2, 1), terms) for B in (C, S, k * C, k * S))
    w = (n1 / sr).astype(dtype)[:, None]
    ps, pc = s0 * gc + c0 * gs, c0 * gc - s0 * gs
    psk, pck = s0 * gck + c0 * gsk, c0 * gck - s0 * gsk
    grad_amp = ps.sum(axis=1)
    grad_d = -a * (w * ps + psk / sr).sum(axis=1)
    grad_f = 2 * np.pi * a * (w * pc + pck / sr).sum(axis=1)
    return grad_f, grad_d, grad_amp


def _trainer_modes(A, M, seed):
    """Mode tables shaped like the trainer's: damped frequencies across the
    audible band, Rayleigh damping (alpha 6, beta 1e-7), amplitudes."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(50.0, 15000.0, (A, M))
    d = 0.5 * (6.0 + 1e-7 * (2 * np.pi * f) ** 2)
    return f, d, rng.uniform(0.1, 1.0, (A, M))


SHAPES = [(1, 16, 8000), (3, 40, 1000), (2, 12, 50)]


@pytest.mark.parametrize("A,M,T", SHAPES)
def test_mirror_of_kernel_forward_within_a_fifth_of_the_gate(A, M, T):
    f, d, a = (x.astype(np.float32) for x in _trainer_modes(A, M, seed=A * 1000 + M))
    ref = synth_constant_modes_plain(*map(torch.as_tensor, (f, d, a)), T, SR).numpy()
    gate = 1e-5 * np.abs(a).sum(axis=1, keepdims=True)
    out = {terms: _mirror_fwd(f, d, a, T, SR, np.float32, terms) for terms in (3, 1)}
    assert out[3].shape == (A, T) and out[3].dtype == np.float32
    share = {terms: float((np.abs(x - ref) / gate).max()) for terms, x in out.items()}
    print(f"mirror forward ({A},{M},{T}): error / gate, 3xTF32 {share[3]:.4g}, "
          f"plain TF32 {share[1]:.4g}")
    # 3xTF32 within a fifth of the gate; plain TF32 past it (10 to 16 times)
    assert share[3] <= 0.2 and share[1] > 1.0, share


@pytest.mark.parametrize("cotangent", ["normal", "ones"])
@pytest.mark.parametrize("A,M,T", SHAPES)
def test_mirror_of_kernel_backward_gate_passes_3xtf32_fails_plain_tf32(A, M, T, cotangent):
    f, d, a = (x.astype(np.float32) for x in _trainer_modes(A, M, seed=A * 1000 + M))
    g = (np.random.default_rng(M).standard_normal((A, T)) if cotangent == "normal"
         else np.ones((A, T))).astype(np.float32)
    ref = synth_constant_modes_bwd_plain(*(torch.as_tensor(x.astype(np.float64))
                                           for x in (f, d, a, g)), T, SR)
    share = {}
    for terms in (3, 1):
        got = _mirror_bwd(f, d, a, g, T, SR, np.float32, terms)
        assert all(x.shape == (A, M) and x.dtype == np.float32 for x in got)
        share[terms] = max(float(np.abs(x - y.numpy()).max() / np.abs(y.numpy()).max())
                           for x, y in zip(got, ref)) / 1e-4
    print(f"mirror backward ({A},{M},{T}), {cotangent} cotangent: relative error / 1e-4, "
          f"3xTF32 {share[3]:.4g}, plain TF32 {share[1]:.4g}")
    # the gate of tests/test_torch_cuda.py, 1e-4 of max|grad|: 3xTF32 within
    # a fifth of it; plain TF32 past it (1.7 to 42 times)
    assert share[3] <= 0.2 and share[1] > 1.0, share


@pytest.mark.parametrize("A,M,T", SHAPES)
def test_mirror_of_kernel_algebra_matches_direct_sums_f64(A, M, T):
    # sr a power of two: (t+1)/sr is then exact in float32 too, so the plain
    # versions' float32 envelope time is the factorised one
    sr = 32768.0
    f, d, a = _trainer_modes(A, M, seed=A + M)
    g = np.random.default_rng(M).standard_normal((A, T))
    ts = [torch.as_tensor(x) for x in (f, d, a)]
    ref = synth_constant_modes_plain(*ts, T, sr).numpy()
    np.testing.assert_allclose(_mirror_fwd(f, d, a, T, sr, np.float64), ref,
                               rtol=0, atol=1e-12 * np.abs(ref).max())
    want = synth_constant_modes_bwd_plain(*ts, torch.as_tensor(g), T, sr)
    for x, y in zip(_mirror_bwd(f, d, a, g, T, sr, np.float64), want):
        y = y.numpy()
        assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max()
