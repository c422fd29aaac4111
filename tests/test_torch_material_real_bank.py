"""The modules of the port's material_real path against the JAX package, in
float64 on the CPU: the GT oscillator bank (both branches, with and without
noise), the OscillatorBank (`__call__`, `forward_curve`, `pretrain_damps`),
`synth_time_varying`, the utility losses, the audio IO and the parameter
carrier `convert.osc_params_from_jax`.

Parameters are JAX's draws carried across as numpy.  The synthesis is
compared with JAX op by op: jitted, XLA rewrites the f32 envelope time
(n+1)/sr and moves JAX's own signal by 1e-7 relative, and the port follows
the op-by-op arithmetic.  Tolerances: 1e-10 relative to
the largest magnitude of a signal or gradient (the sums of a few thousand
f64 terms in different orders), 1e-12 on closed forms, bit-equality on the
numpy/scipy copies of the audio IO."""

import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio import io as jio
from diffsound_tpu.audio import mss_loss as jmss
from diffsound_tpu.audio import oscillator as josc
from diffsound_tpu.fem.material import Material as JMaterial, MatSet as JMatSet

from diffsound_torch.audio import io as tio
from diffsound_torch.audio import mss_loss as tmss
from diffsound_torch.audio import oscillator as tosc
from diffsound_torch.convert import osc_params_from_jax
from diffsound_torch.fem.material import Material, MatSet

torch.set_num_threads(2)

A, M, T, SR = 2, 8, 500, 32000.0
RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _jax_params(bank, seed=0):
    return jax.tree_util.tree_map(np.array,
                                  bank.init_params(jax.random.PRNGKey(seed), jnp.float64))


def _leaves(params):
    return {k: v.clone().requires_grad_(True) for k, v in params.items()}


def _flat_grads(grads):
    """JAX's gradient pytree flattened to the port's keys."""
    out = {}
    for k, v in grads.items():
        if isinstance(v, dict):
            out.update({f"{k}_{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _gt_banks(nonlinear=False):
    jb = josc.GTOscillatorBank(A, M, T, SR, JMaterial.of(JMatSet.Ceramic),
                               use_nonlinear=nonlinear)
    tb = tosc.GTOscillatorBank(A, M, T, SR, Material.of(MatSet.Ceramic),
                               use_nonlinear=nonlinear)
    return jb, tb


def _run_gt(jb, tb, jp, noise_rate=0.0, non_linear_rate=0.0, forces=None):
    """Both banks' signal, reported damped frequencies and the gradients of
    <signal, w> to every parameter."""
    key = jax.random.PRNGKey(3)
    w = np.random.default_rng(5).normal(size=(A, T))
    fz = None if forces is None else jnp.asarray(forces)

    def jf(p):
        sig, fd = jb(p, fz, noise_rate=noise_rate, key=key, non_linear_rate=non_linear_rate)
        return jnp.sum(sig * w), (sig, fd)

    (_, (sig_j, fd_j)), g_j = jax.value_and_grad(jf, has_aux=True)(jp)
    tp = _leaves(osc_params_from_jax(jp, dtype=torch.float64))
    # the white noise JAX's FilteredNoise draws from `key`
    noise = None
    if noise_rate > 0:
        fn = tb.noise()
        noise = torch.as_tensor(np.array(jax.random.uniform(
            key, (fn.noise_num, fn.frame_num, fn.frame_length), jnp.float64) * 2.0 - 1.0))
    sig_t, fd_t = tb(tp, None if forces is None else torch.as_tensor(forces),
                     noise_rate=noise_rate, non_linear_rate=non_linear_rate, noise=noise)
    (sig_t * torch.as_tensor(w)).sum().backward()
    return (sig_t.detach(), fd_t.detach(), {k: v.grad for k, v in tp.items()},
            np.asarray(sig_j), np.asarray(fd_j), _flat_grads(g_j))


@pytest.mark.parametrize("noise_rate", [0.0, 0.05])
def test_gt_bank_constant_modes_match_jax(noise_rate):
    jb, tb = _gt_banks()
    jp = _jax_params(jb)
    forces = np.zeros((A, 30))
    forces[:, 0], forces[:, 3] = 1.0, -0.4
    sig_t, fd_t, g_t, sig_j, fd_j, g_j = _run_gt(jb, tb, jp, noise_rate=noise_rate,
                                                 forces=forces)
    _close(sig_t, sig_j)
    _close(fd_t, fd_j, 1e-12)
    assert set(g_t) == set(g_j) == {"freq_logits", "alpha_logits", "beta_logits",
                                    "amp_raw", "noise_coeff_bank"}
    for k in g_j:
        if noise_rate == 0.0 and k == "noise_coeff_bank":
            assert g_t[k] is None and not np.any(g_j[k])
            continue
        _close(g_t[k], g_j[k])


def test_gt_bank_nonlinear_branch_matches_jax():
    jb, tb = _gt_banks(nonlinear=True)
    jp = _jax_params(jb)
    assert jp["nl_freq_logits"].shape == (A, M, T, 2)
    sig_t, fd_t, g_t, sig_j, fd_j, g_j = _run_gt(jb, tb, jp, non_linear_rate=0.5)
    _close(sig_t, sig_j)
    _close(fd_t, fd_j, 1e-12)
    for k in ("freq_logits", "alpha_logits", "beta_logits", "amp_raw", "nl_freq_logits"):
        _close(g_t[k], g_j[k])


def test_gt_bank_over_damped_modes_clamp_like_jax():
    """Modes whose damping exceeds 2 pi f (heavy alpha at 20 Hz) clamp their
    damped frequency to sqrt(1e-12) / 2 pi: the values and the gradient
    through the clamp match JAX's."""
    jb, tb = _gt_banks()
    jp = _jax_params(jb)
    jp["freq_logits"][:4] = [8.0, -8.0]  # f near 21 Hz
    jp["alpha_logits"][:4] = -8.0
    jp["alpha_logits"][:4, -8:] = 8.0  # alpha near 450: d ~ 225 > 2 pi 21
    sig_t, fd_t, g_t, sig_j, fd_j, g_j = _run_gt(jb, tb, jp)
    fd = np.asarray(fd_j)
    assert np.all(fd[:4] < 1e-6) and np.all(fd[4:] > 1.0)
    _close(fd_t, fd_j, 1e-12)
    _close(sig_t, sig_j)
    for k in ("freq_logits", "alpha_logits", "beta_logits", "amp_raw"):
        _close(g_t[k], g_j[k])


def test_gt_bank_damping_and_frequencies_match_jax():
    jb, tb = _gt_banks()
    jp = _jax_params(jb)
    tp = osc_params_from_jax(jp, dtype=torch.float64)
    _close(tb.freq_linear(tp), jb.freq_linear(jp), 1e-13)
    _close(tb.damping(tp), jb.damping(jp), 1e-13)


def test_gt_bank_draw_has_jax_shapes_and_ranges():
    jb, tb = _gt_banks(nonlinear=True)
    want = {k: v.shape for k, v in osc_params_from_jax(_jax_params(jb)).items()}
    got = tb.init_params(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    for k, (lo, hi) in {"freq_logits": (-4, 4), "alpha_logits": (-4, 4), "amp_raw": (0, 0.04),
                        "noise_coeff_bank": (-1, 1)}.items():
        assert lo <= float(got[k].min()) and float(got[k].max()) < hi
    again = tb.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


def _osc_banks():
    mat = (2700.0, 5.6e10, 0.27, 6.0, 1e-7)
    return (josc.OscillatorBank(A, M, T, SR, JMaterial.of(mat)),
            tosc.OscillatorBank(A, M, T, SR, Material.of(mat)))


def test_oscillator_bank_call_and_forward_curve_match_jax():
    jb, tb = _osc_banks()
    jp = _jax_params(jb)
    rng = np.random.default_rng(8)
    f_und = np.sort(rng.uniform(300.0, 15000.0, M))
    curve = rng.uniform(3.0, 200.0, M)
    w = rng.normal(size=(A, T))
    forces = np.zeros((A, 20))
    forces[:, 0] = 1.0

    for name in ("call", "curve"):
        def jf(p, f):
            out = (jb(p, f, jnp.asarray(forces)) if name == "call"
                   else jb.forward_curve(p, f, jnp.asarray(curve), jnp.asarray(forces)))
            return jnp.sum(out[0] * w), out

        (_, (sig_j, fd_j)), (gp_j, gf_j) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(f_und))
        tp = _leaves(osc_params_from_jax(jp, dtype=torch.float64))
        ft = torch.tensor(f_und, requires_grad=True)
        sig_t, fd_t = (tb(tp, ft, torch.as_tensor(forces)) if name == "call" else
                       tb.forward_curve(tp, ft, torch.as_tensor(curve), torch.as_tensor(forces)))
        (sig_t * torch.as_tensor(w)).sum().backward()
        _close(sig_t.detach(), sig_j)
        _close(fd_t.detach(), fd_j, 1e-12)
        _close(ft.grad, gf_j)
        for k, g in gp_j.items():
            if name == "curve":  # forward_curve reads only amp_raw's dtype
                assert tp[k].grad is None and not np.any(np.asarray(g))
            else:
                _close(tp[k].grad, g)
    # forward_curve's rows are max-normalized
    np.testing.assert_allclose(sig_t.detach().abs().amax(dim=1).numpy(), 1.0, rtol=1e-15)


def test_pretrain_damps_matches_jax():
    """300 Adam steps of the alpha/beta logits toward the table's values."""
    jb, tb = _osc_banks()
    jp = _jax_params(jb)
    got = tb.pretrain_damps(osc_params_from_jax(jp, dtype=torch.float64), steps=300)
    want = jb.pretrain_damps(jax.tree_util.tree_map(jnp.asarray, jp), steps=300)
    for k in ("alpha_logits", "beta_logits"):
        _close(got[k], want[k], 1e-9)
    assert torch.equal(got["amp_raw"], torch.as_tensor(jp["amp_raw"]))
    _close(tb.alpha(got), jb.alpha(want), 1e-12)
    _close(tb.beta(got), jb.beta(want), 1e-12)
    # and they moved toward the table
    start = osc_params_from_jax(jp, dtype=torch.float64)
    assert abs(float(tb.alpha(got).mean()) - 6.0) < abs(float(tb.alpha(start).mean()) - 6.0)


def test_synth_time_varying_matches_jax():
    rng = np.random.default_rng(9)
    freqs = rng.uniform(100.0, 9000.0, (A, 4, T)) + rng.normal(0, 5.0, (A, 4, T))
    damps = rng.uniform(5.0, 80.0, (A, 4, T))
    amps = rng.uniform(0.2, 1.0, (A, 4, 1))
    forces = rng.normal(size=(A, 12))
    w = rng.normal(size=(A, T))
    args = [jnp.asarray(x) for x in (freqs, damps, amps)]
    f = lambda fr, d, am: josc.synth_time_varying(fr, d, am, SR, jnp.asarray(forces))
    out_j, vjp = jax.vjp(jax.jit(f), *args)
    ts = [torch.tensor(x, requires_grad=True) for x in (freqs, damps, amps)]
    out_t = tosc.synth_time_varying(*ts, SR, torch.as_tensor(forces))
    (out_t * torch.as_tensor(w)).sum().backward()
    _close(out_t.detach(), out_j)
    for t, g in zip(ts, vjp(jnp.asarray(w))):
        _close(t.grad, g)


def test_synth_signal_is_synth_constant_modes():
    rng = np.random.default_rng(10)
    f, d, a = (torch.as_tensor(rng.uniform(lo, hi, (A, M)))
               for lo, hi in ((100, 9000), (3, 90), (0.1, 1)))
    assert torch.equal(tosc.synth_signal(f, d, a, T, SR),
                       tosc.synth_constant_modes(f, d, a, T, SR))


def test_utility_losses_match_jax():
    rng = np.random.default_rng(11)
    sp, st = rng.normal(size=(2, 33, 9)), rng.normal(size=(2, 33, 9))
    pf = np.sort(rng.uniform(200, 9000, 6))
    gf = np.sort(rng.uniform(200, 9000, 5))
    damp = rng.uniform(5, 90, 6)
    mel = rng.uniform(0, 3000, 7)
    cases = [
        (jmss.lsd_loss, tmss.lsd_loss, (sp, st)),
        (jmss.mode_loss, tmss.mode_loss, (pf, gf)),
        (jmss.mel_scale, tmss.mel_scale, (pf,)),
        (jmss.inv_mel_scale, tmss.inv_mel_scale, (mel,)),
        (lambda f, d: jmss.reconstruct_signal(f, d, 400, SR),
         lambda f, d: tmss.reconstruct_signal(f, d, 400, SR), (pf, damp)),
    ]
    for jfn, tfn, args in cases:
        out_j, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in args))
        ts = [torch.tensor(x, requires_grad=True) for x in args]
        out_t = tfn(*ts)
        w = rng.normal(size=np.shape(out_j))
        (out_t * torch.as_tensor(w)).sum().backward()
        _close(out_t.detach(), out_j, 1e-12)
        for t, g in zip(ts, vjp(jnp.asarray(w))):
            _close(t.grad, g, 1e-11)


def _write_pcm(path, frames: np.ndarray, width: int, sr: int, nch: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(frames.tobytes())


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_matches_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    n, nch = 300, 2
    if width == 1:
        raw = rng.integers(0, 256, n * nch).astype(np.uint8)
    elif width == 3:
        raw = rng.integers(0, 256, n * nch * 3).astype(np.uint8)
    else:
        dt = "<i2" if width == 2 else "<i4"
        raw = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n * nch).astype(dt)
    path = tmp_path / "x.wav"
    _write_pcm(path, raw, width, 22050, nch)
    got, sr = tio.read_wav(str(path))
    want, sr_j = jio.read_wav(str(path))
    assert sr == sr_j == 22050 and got.shape == (nch, n)
    np.testing.assert_array_equal(got, want)


def test_write_wav_resample_highpass_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    x = rng.uniform(-0.9, 0.9, (2, 1200))
    tio.write_wav(str(tmp_path / "t.wav"), x, 16000)
    jio.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(tio.resample(x, 48000, 32000), jio.resample(x, 48000, 32000))
    np.testing.assert_array_equal(tio.highpass_biquad(x, 32000, 100.0),
                                  jio.highpass_biquad(x, 32000, 100.0))
    np.testing.assert_array_equal(tio.gain_db(x, -6.0), jio.gain_db(x, -6.0))


def test_load_real_audio_dir_matches_jax(tmp_path):
    """Synthetic mic*.wav recordings at 48 kHz with a metadata.yaml (gain and
    pad), one shorter than frame_num, and a file that is not a mic."""
    rng = np.random.default_rng(13)
    sr = 48000
    t = np.arange(9000) / sr
    for i in range(3):
        x = 0.3 * np.sin(2 * np.pi * (500 + 700 * i) * t) * np.exp(-20 * t)
        x = x[: 9000 if i != 1 else 3000] + 1e-3 * rng.normal(size=9000 if i != 1 else 3000)
        tio.write_wav(str(tmp_path / f"mic{i}.wav"), x, sr)
    tio.write_wav(str(tmp_path / "other.wav"), rng.uniform(-1, 1, 500), sr)
    (tmp_path / "metadata.yaml").write_text("gain:\n- 0.0\n- 6.0\npad:\n- 0.0\n- 0.01\n")
    for audio_num in (2, 8):
        got, sr_t = tio.load_real_audio_dir(str(tmp_path), 32000.0, 4000, audio_num)
        want, sr_j = jio.load_real_audio_dir(str(tmp_path), 32000.0, 4000, audio_num)
        assert got.shape == (min(audio_num, 3), 4000) and sr_t == sr_j
        np.testing.assert_array_equal(got, want)
        assert np.isclose(np.abs(got).max(), 1.0) and np.all(got[1, 1700:] == 0.0)
    os.remove(tmp_path / "metadata.yaml")
    np.testing.assert_array_equal(tio.load_real_audio_dir(str(tmp_path), 32000.0, 4000)[0],
                                  jio.load_real_audio_dir(str(tmp_path), 32000.0, 4000)[0])


def test_osc_params_from_jax_flattens_the_noise_params():
    jb, _ = _gt_banks()
    jp = _jax_params(jb)
    tp = osc_params_from_jax(jp, dtype=torch.float64)
    assert set(tp) == {"freq_logits", "alpha_logits", "beta_logits", "amp_raw",
                       "noise_coeff_bank"}
    np.testing.assert_array_equal(tp["noise_coeff_bank"].numpy(), jp["noise"]["coeff_bank"])
    assert tp["amp_raw"].dtype == torch.float64
    assert osc_params_from_jax(jp)["amp_raw"].dtype == torch.float32
