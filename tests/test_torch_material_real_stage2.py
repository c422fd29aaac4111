"""Stage 2 of the port's material_real task against the JAX package on the
CPU: `train_material_real` from the modal-Newton start through one Sinkhorn
(`geomloss`) epoch, the switch with the optimizer reset, and 15 L1 epochs
past a warm refresh, on the cube, damping curve and recording of
tests/test_real_audio.py::test_stage2_newton_init_recovers_material.

JAX's `train_material_real` draws its OscillatorBank params in float32 and
rounds the recordings to float32, so its synthesis and losses run in
float32 whatever the model's dtype (its Sinkhorn needs the prediction and
the target in one dtype, so neither can be widened alone); the port's run
in float64.  The comparison is therefore held to float32's rounding: the
Newton fit (float64 in both) within 1e-5, E, nu and the L1 loss within
1e-5, the RMSE within 1e-4, and the Sinkhorn loss near its zero to an
absolute 5e-2 (0.8 against terms of 4e4 whose float32 rounding lands there;
at a random start JAX's float32 and float64 losses differ by 7e-7 relative
and the port's float64 equals JAX's float64 to 1e-15)."""

import numpy as np
import torch

import jax.numpy as jnp

from diffsound_tpu.audio.damping import DampingCurve as JDampingCurve
from diffsound_tpu.audio.oscillator import synth_constant_modes as jsynth
from diffsound_tpu.experiments import material_real as jreal
from diffsound_tpu.fem.mesh import cube_tet_mesh as jcube
from diffsound_tpu.models import modal_fit as jmodal_fit
from diffsound_tpu.models.sound_obj import build_model as jbuild

from diffsound_torch.audio.damping import DampingCurve
from diffsound_torch.experiments.material_real import train_material_real
from diffsound_torch.fem.mesh import cube_tet_mesh

torch.set_num_threads(2)

SR = 32000.0


def _stage2_inputs():
    """tests/test_real_audio.py::test_stage2_newton_init_recovers_material's
    cube, modes, damping curve and recording."""
    mesh = jcube(3, size=0.4)
    modes, T = 10, 6000
    gt = (2700.0, 5.6e10, 0.27, 6.0, 1e-7)
    gt_model = jbuild(mesh=mesh, mode_num=modes, order=1, mat=gt, task="gt",
                      dtype=jnp.float64)
    eig = gt_model.eigen_decomposition(method="arpack", sigma=1e6)
    f_und = np.asarray(gt_model.get_undamped_freqs({}, eig))
    xs = np.linspace(100.0, 16000.0, 50)
    curve_args = (xs, 4.0 + 1e-3 * xs)
    d = np.asarray(JDampingCurve(*curve_args)(f_und))
    fd = np.sqrt(np.maximum((2 * np.pi * f_und) ** 2 - d**2, 0.0)) / (2 * np.pi)
    audio = np.asarray(jsynth(jnp.asarray(fd, jnp.float32)[None, :],
                              jnp.asarray(d, jnp.float32)[None, :],
                              jnp.ones((1, modes), jnp.float32), T, SR))
    return mesh, modes, curve_args, audio


def _record_newton_fits(monkeypatch):
    fits = []
    fit = jmodal_fit.ModalNewtonFitter.fit

    def recording(self, *a, **kw):
        fits.append(fit(self, *a, **kw))
        return fits[-1]

    monkeypatch.setattr(jmodal_fit.ModalNewtonFitter, "fit", recording)
    return fits


def test_train_material_real_matches_jax(monkeypatch):
    """The modal-Newton start, one geomloss epoch, the switch with the
    optimizer reset, and 15 L1 epochs past a warm refresh: the Newton fit,
    the log history (epochs 0 and 15: loss, RMSE, E, nu) and the final E,
    nu (tolerances in the module's docstring)."""
    mesh, modes, curve_args, audio = _stage2_inputs()
    fits = _record_newton_fits(monkeypatch)
    init = (2700.0, 3.4e10, 0.18, 6.0, 1e-7)
    kw = dict(exp_mode=2, mode_num=modes, sample_rate=SR, max_epoch=16, early_loss_epoch=1,
              verbose=False, newton_init=True)
    rj = jreal.train_material_real(mesh, audio, JDampingCurve(*curve_args), init, **kw)
    rt = train_material_real(cube_tet_mesh(3, size=0.4), audio, DampingCurve(*curve_args),
                             init, device="cpu", **kw)
    (fit_j,) = fits
    np.testing.assert_allclose(rt["newton"]["E"], fit_j["E"], rtol=1e-5)
    np.testing.assert_allclose(rt["newton"]["nu"], fit_j["nu"], rtol=1e-5)
    # the fit lands near the recording's material, as the JAX test asks
    assert abs(rt["newton"]["E"] / 5.6e10 - 1) < 0.04 and abs(rt["newton"]["nu"] - 0.27) < 0.05
    assert rt["losses"].shape == (16,) and np.isfinite(rt["losses"]).all()
    assert len(rt["cold_s"]) == 1 and len(rt["refresh_s"]) == len(rt["refresh_iters"]) == 1
    assert [h["epoch"] for h in rt["history"]] == [h["epoch"] for h in rj["history"]] == [0, 15]
    for ht, hj in zip(rt["history"], rj["history"]):
        for k in ("youngs", "poisson"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5)
        np.testing.assert_allclose(ht["rmse"], hj["rmse"], rtol=1e-4)
    (h0t, h15t), (h0j, h15j) = rt["history"], rj["history"]
    np.testing.assert_allclose(h0t["loss"], h0j["loss"], rtol=0, atol=5e-2)
    np.testing.assert_allclose(h15t["loss"], h15j["loss"], rtol=1e-5)
    np.testing.assert_allclose(rt["youngs"], rj["youngs"], rtol=1e-5)
    np.testing.assert_allclose(rt["poisson"], rj["poisson"], rtol=1e-5)
    assert rt["step_s"]["early"] > 0 and rt["step_s"]["late"] > 0
