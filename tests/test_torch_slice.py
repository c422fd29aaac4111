"""Whole-slice parity of the port with the JAX package, in f64 on a small
order-2 cube mesh: the flagship training step (params -> corrected modal
frequencies -> synthesis -> 5-scale L1, value and gradient), 30 epochs of
MaterialSyncTask.train on flagship pair 0 with two eigensolves (one cold,
one warm refresh), and the trainer's optimizer against optax's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffsound_tpu.audio.mss_loss import MSSLoss as JMSS
from diffsound_tpu.audio.oscillator import TraditionalOscillatorParams as JOsc
from diffsound_tpu.experiments.material_sync import MaterialSyncTask as JTask
from diffsound_tpu.fem.material import Material as JMaterial
from diffsound_tpu.models import sound_obj as jso
from diffsound_tpu.models.sound_obj import EigenState as JEig
from diffsound_tpu.models.sound_obj import build_model as jbuild

from diffsound_torch.audio.mss_loss import MSSLoss
from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
from diffsound_torch.convert import eigen_state_from_numpy, params_from_jax
from diffsound_torch.experiments.material_sync import (
    MaterialSyncTask, adam_step_decay, flagship_material_pairs,
)
from diffsound_torch.fem.material import Material
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.models.sound_obj import build_model

torch.set_num_threads(2)

MAT = (2700, 7.2e10, 0.19, 6, 1e-7)
MODES, T, SR, NF = 8, 2000, 32000.0, 150
N_FFTS = [1024, 512, 256, 128, 64]
TASK_KW = dict(mode_num=MODES, sample_rate=SR, frame_num=T, force_frame_num=NF, exp_mode=3)
TRAIN_KW = dict(max_epoch=30, early_loss_epoch=0, late_freq_weight=0.0, verbose=False,
                seed=0)


@pytest.mark.parametrize("cached", [True, False])
def test_flagship_step_value_and_grad(cached):
    mesh = cube_tet_mesh(2, 0.5)
    jm = jbuild(mesh=mesh, mode_num=MODES, order=2, mat=MAT, task="material",
                dtype=jnp.float64)
    tm = build_model(mesh=mesh, mode_num=MODES, order=2, mat=MAT, task="material",
                     dtype=torch.float64, device="cpu")
    eig_j = jm.eigen_decomposition(method="arpack")
    vals, vecs = np.asarray(eig_j.eigenvalues), np.asarray(eig_j.eigenvectors)
    eig_t = eigen_state_from_numpy(vals, vecs, torch.float64)
    # f64 logits in both packages (f32 param math differs in the last ulp)
    p64 = {k: np.asarray(v, np.float64)
           for k, v in jm.init_params(jax.random.PRNGKey(5), pretrain=False).items()}
    target = np.random.default_rng(6).standard_normal((1, T)) * 0.05
    forces = np.zeros((1, NF))
    forces[0, 0] = 1.0

    osc_j = JOsc(1, MODES, T, SR, JMaterial.of(MAT))
    mss_j = JMSS(N_FFTS, SR, loss_type="l1_loss")
    # the loss as one compiled program: op by op, JAX compiles each of its
    # many small ops on its own, which takes five times longer
    loss_j = jax.jit(lambda sig, damped: mss_j(sig, jnp.asarray(target), damped, 1.0))
    cache_j = jm.modal_cache(eig_j)

    def fn_j(params):
        freqs = (jm.get_undamped_freqs_cached(params, cache_j) if cached
                 else jm.get_undamped_freqs(params, JEig(eig_j.eigenvalues,
                                                         eig_j.eigenvectors, 0, 0)))
        sig, damped = osc_j(freqs, jnp.asarray(forces), dtype=jnp.float64)
        return loss_j(sig, damped)

    vj, gj = jax.value_and_grad(fn_j)({k: jnp.asarray(v) for k, v in p64.items()})

    osc_t = TraditionalOscillatorParams(1, MODES, T, SR, Material.of(MAT))
    loss_t = MSSLoss(N_FFTS, SR, loss_type="l1_loss")
    pt = params_from_jax(p64, dtype=torch.float64)
    for v in pt.values():
        v.requires_grad_(True)
    freqs = (tm.get_undamped_freqs_cached(pt, tm.modal_cache(eig_t)) if cached
             else tm.get_undamped_freqs(pt, eig_t))
    sig, damped = osc_t(freqs, torch.as_tensor(forces), dtype=torch.float64)
    vt = loss_t(sig, torch.as_tensor(target), damped, 1.0)
    gt = torch.autograd.grad(vt, list(pt.values()))

    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-9)
    for g, k in zip(gt, pt):
        gk = np.asarray(gj[k])
        np.testing.assert_allclose(g.numpy(), gk, rtol=1e-7, atol=1e-7 * np.abs(gk).max())


@pytest.fixture(scope="module")
def pair0():
    """Flagship pair 0 on the small mesh, the recipe the CLI runs: JAX's
    ground truth, JAX's 30-epoch run from its own pretrained start, and the
    port's 30 epochs from exactly those pretrained logits."""
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    mesh = cube_tet_mesh(2, 0.5)
    jt = JTask(mesh=mesh, **TASK_KW, dtype=jnp.float64)
    gt_audio, gt_freqs = jt.make_gt(gt_mat)
    rj = jt.train(init_mat, gt_audio, pretrain=True, **TRAIN_KW)
    # train's own start: init_params(PRNGKey(seed)) followed by pretrain
    jm = jbuild(mesh=mesh, mode_num=MODES, order=2, mat=init_mat, task="material",
                dtype=jnp.float64)
    logits = {k: np.asarray(v)
              for k, v in jm.init_params(jax.random.PRNGKey(0), pretrain=True).items()}
    tt = MaterialSyncTask(mesh=mesh, **TASK_KW, device="cpu")
    rt = tt.train(init_mat, torch.as_tensor(np.asarray(gt_audio)), pretrain=False,
                  init_logits=logits, **TRAIN_KW)
    return dict(init_mat=init_mat, gt_mat=gt_mat, jt=jt, tt=tt, gt_audio=gt_audio,
                gt_freqs=gt_freqs, rj=rj, rt=rt, logits=logits,
                start=float(jm.bins.youngs({k: jnp.asarray(v) for k, v in logits.items()})))


def _rel_gap(r, ref):
    return max(abs(r["youngs"] / ref["youngs"] - 1), abs(r["poisson"] / ref["poisson"] - 1))


def test_material_sync_train_30_epochs_matches_jax(pair0):
    tt, rt, rj = pair0["tt"], pair0["rt"], pair0["rj"]
    assert tt.dtype == torch.float64
    gt_t, gt_freqs_t = tt.make_gt(pair0["gt_mat"])
    gt_audio = np.asarray(pair0["gt_audio"])
    np.testing.assert_allclose(gt_freqs_t, np.asarray(pair0["gt_freqs"]), rtol=1e-10)
    np.testing.assert_allclose(gt_t.numpy(), gt_audio, rtol=1e-8,
                               atol=1e-8 * np.abs(gt_audio).max())

    assert len(rt["refresh_iters"]) == 1 and rt["refresh_iters"][0] > 0
    assert rt["losses"].shape == (30,) and np.isfinite(rt["losses"]).all()
    np.testing.assert_allclose(rt["youngs"], rj["youngs"], rtol=1e-5)
    np.testing.assert_allclose(rt["poisson"], rj["poisson"], rtol=1e-5)
    np.testing.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-4)
    for ht, hj in zip(rt["history"], rj["history"]):
        assert ht["epoch"] == hj["epoch"]
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    # E moved from the pretrained start as far as JAX moved it (on this
    # pair the L1 recipe moves E away from the target, in both packages)
    start = pair0["start"]
    np.testing.assert_allclose(rt["youngs"] - start, rj["youngs"] - start, rtol=1e-2)
    assert abs(rj["youngs"] / start - 1) > 1e-4


def test_jax_train_moves_more_under_one_ulp_than_the_port_differs(pair0, monkeypatch):
    """Witness for the tolerance above: the bin logits are f32 in both
    packages, and a one-ulp move of JAX's own start moves JAX's result after
    30 epochs further than the port is from JAX.  Run with -s to see both."""
    moved = {k: jnp.asarray(np.nextafter(v, np.float32(np.inf)))
             for k, v in pair0["logits"].items()}
    monkeypatch.setattr(jso.DiffSoundObject, "init_params",
                        lambda self, key, pretrain=True: dict(moved))
    rj_ulp = pair0["jt"].train(pair0["init_mat"], pair0["gt_audio"], pretrain=True,
                               **TRAIN_KW)
    port_gap, ulp_gap = _rel_gap(pair0["rt"], pair0["rj"]), _rel_gap(rj_ulp, pair0["rj"])
    rj = pair0["rj"]
    print(f"flagship pair 0, 30 epochs: JAX E {pair0['start']:.6g} -> {rj['youngs']:.6g} "
          f"(target {pair0['gt_mat'][1]:.6g}), port E {pair0['rt']['youngs']:.6g}; "
          f"port vs JAX {port_gap:.3e}; JAX vs JAX from logits one ulp up {ulp_gap:.3e} "
          f"(largest relative gap in E, nu)")
    assert port_gap < ulp_gap


def test_adam_step_decay_matches_optax():
    """The trainer's optimizer: Adam with the learning rate falling by gamma
    every 100 steps, against optax.adam(exponential_decay(staircase=True)),
    across two decay boundaries."""
    rng = np.random.default_rng(7)
    x0, c = rng.standard_normal(16), rng.standard_normal(16)

    def grad(x):  # positive everywhere, so no component settles at an optimum
        return 1 + c**2 + np.exp(0.3 * x) * (1 + 0.5 * np.sin(3 * x))

    opt_j = optax.adam(optax.exponential_decay(5e-3, 100, 0.9, staircase=True))
    xj = jnp.asarray(x0)
    state = opt_j.init(xj)
    xt = torch.tensor(x0, requires_grad=True)
    opt_t, sched = adam_step_decay([xt], 5e-3, 0.9)
    for _ in range(250):
        upd, state = opt_j.update(jnp.asarray(grad(np.asarray(xj))), state)
        xj = optax.apply_updates(xj, upd)
        xt.grad = torch.as_tensor(grad(xt.detach().numpy()))
        opt_t.step()
        sched.step()
    # The two libraries round Adam's bias corrections differently: x ends
    # ~5e-8 apart after 250 steps of ~1.2 travel.  A schedule one step off
    # at a decay boundary moves x by ~1.5e-3.
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    assert sched.get_last_lr()[0] == pytest.approx(5e-3 * 0.9**2)
