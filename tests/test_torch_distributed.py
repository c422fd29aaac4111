"""The port's (dp, ep) layer on torch.distributed with gloo on the CPU,
against the JAX package and against the port in one process, in f64:
`ShardedFEM` at ep = 4 and ep = 2 against JAX's assembly, the trainer at
(dp, ep) = (2, 2) against (1, 1) over three steps (the second a warm
refresh) within tests/test_multipair.py's tolerances, `dryrun_multichip(4)`,
and `BatchedModalNewton` against JAX's on
test_batched_newton_fit_recovers_both_pairs's setup.  Each gloo run is
spawned once and must finish within SPAWN_TIMEOUT seconds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsound_tpu.audio.freq_loss import extract_spectral_peaks as jpeaks
from diffsound_tpu.audio.oscillator import TraditionalOscillatorParams as JOsc
from diffsound_tpu.experiments.material_sync import impulse_forces as jforces
from diffsound_tpu.fem.material import Material as JMaterial
from diffsound_tpu.fem.material import lame_params as jlame
from diffsound_tpu.fem.mesh import cube_tet_mesh as jcube
from diffsound_tpu.models.sound_obj import build_model as jbuild
from diffsound_tpu.parallel.mesh import make_device_mesh as jmesh
from diffsound_tpu.parallel.newton import BatchedModalNewton as JNewton
from diffsound_tpu.parallel.train import MultipairTrainer as JTrainer

import torch_parallel_workers as W
from test_torch_parallel import check_fem, fem_reference
from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
from diffsound_torch.experiments.material_sync import impulse_forces
from diffsound_torch.fem.material import Material
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.models.sound_obj import build_model
from diffsound_torch.parallel.dryrun import dryrun_multichip
from diffsound_torch.parallel.mesh import make_device_mesh, spawn
from diffsound_torch.parallel.newton import BatchedModalNewton
from diffsound_torch.parallel.train import MultipairTrainer

torch.set_num_threads(2)

SPAWN_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """One 4-rank gloo run (tests/torch_parallel_workers.py): what rank 0
    saw."""
    out = tmp_path_factory.mktemp("gloo")
    spawn(W.distributed_rank, 4, (str(out),), device="cpu", timeout=SPAWN_TIMEOUT)
    return dict(np.load(out / "rank0.npz"))


@pytest.mark.parametrize("ep", [2, 4])
def test_sharded_fem_under_gloo_matches_jax_assembly(gloo_run, ep):
    got = {k[len(f"ep{ep}_"):]: v for k, v in gloo_run.items() if k.startswith(f"ep{ep}_")}
    check_fem(got, *fem_reference())


def test_dp2_ep2_trainer_equals_one_process(gloo_run):
    """tests/test_multipair.py::test_sharded_equals_single_device's check,
    with a warm refresh as the second step: the ep all-reduce inside the
    batched LOBPCG, the forms and the losses."""
    dmesh = make_device_mesh(1, 1, "cpu")
    _, trainer, eigval_b, eigvec_b, gt_b = W.port_setup(dmesh)
    params_b, opt_b = trainer.init(len(W.TARGETS))
    losses, params = W.port_steps(trainer, params_b, opt_b, eigval_b, eigvec_b, gt_b)
    gap_l = np.abs(gloo_run["losses"] / losses - 1).max()
    gap_p = max(np.abs(gloo_run[f"param_{k}"] - v).max() for k, v in params.items())
    print(f"(2, 2) against (1, 1): losses {gap_l:.3e} relative, params {gap_p:.3e} absolute")
    np.testing.assert_allclose(gloo_run["losses"], losses, rtol=1e-4)
    for k, v in params.items():
        np.testing.assert_allclose(gloo_run[f"param_{k}"], v, rtol=1e-3, atol=1e-5)
    assert np.all(np.isfinite(losses)) and losses.shape == (3, 2)
    assert not np.allclose(losses[0], losses[0, ::-1])


def test_dryrun_multichip_4_ranks_under_gloo():
    dryrun_multichip(4, "cpu", timeout=SPAWN_TIMEOUT)


# -- BatchedModalNewton ----------------------------------------------------------


NEWTON_TARGETS = [(2700, 5.2e10, 0.27, 6, 1e-7), (2700, 9.0e10, 0.14, 6, 1e-7)]
NEWTON_MODES, NEWTON_T = 6, 4000


@pytest.fixture(scope="module")
def jax_newton():
    """test_batched_newton_fit_recovers_both_pairs's setup in the JAX
    package, on a (1, 1) mesh: its peaks, start basis and 10-round fit."""
    mesh = jcube(2, size=0.5)
    f64 = jnp.float64
    model = jbuild(mesh=mesh, mode_num=NEWTON_MODES, order=1, mat=W.BASE, task="material",
                   dtype=f64)
    peaks, pws = [], []
    for t in NEWTON_TARGETS:
        gm = jbuild(mesh=mesh, mode_num=NEWTON_MODES, order=1, mat=t, task="gt", dtype=f64)
        freqs = gm.get_undamped_freqs({}, gm.eigen_decomposition(method="arpack", sigma=1e6))
        sig, _ = JOsc(1, NEWTON_MODES, NEWTON_T, W.SR, JMaterial.of(t))(
            freqs, jforces(1, W.NF, f64), dtype=f64)
        pk, pw = jpeaks(np.asarray(sig), W.SR)
        peaks.append(pk)
        pws.append(pw)
    trainer = JTrainer(bins=model.bins, ops=model.ops,
                       osc=JOsc(1, NEWTON_MODES, NEWTON_T, W.SR, JMaterial.of(W.BASE)),
                       mesh=jmesh(1, 1), forces=jforces(1, W.NF, f64), sample_rate=W.SR)
    eigvec = np.asarray(model.eigen_decomposition(method="arpack", sigma=1e6).eigenvectors)
    mu0, lam0 = jlame(W.BASE[1] / W.BASE[0], W.BASE[2])
    start = (np.full(2, float(mu0)), np.full(2, float(lam0)))
    res = JNewton(trainer, peaks, pws, W.SR, 6.0, 1e-7).fit(
        *start, jnp.stack([jnp.asarray(eigvec)] * 2), rounds=10)
    return dict(peaks=peaks, pws=pws, eigvec=eigvec, start=start, res=res)


def test_batched_newton_fit_matches_jax(jax_newton):
    """The port's fit from JAX's peaks and start basis lands within the JAX
    test's gates (3% in E, 0.04 in nu) and within 1e-3 of JAX's fit."""
    mesh = cube_tet_mesh(2, size=0.5)
    model = build_model(mesh=mesh, mode_num=NEWTON_MODES, order=1, mat=W.BASE, task="material",
                        dtype=torch.float64, device="cpu")
    trainer = MultipairTrainer(
        bins=model.bins, ops=model.ops,
        osc=TraditionalOscillatorParams(1, NEWTON_MODES, NEWTON_T, W.SR, Material.of(W.BASE)),
        mesh=make_device_mesh(1, 1, "cpu"), forces=impulse_forces(1, W.NF, torch.float64),
        sample_rate=W.SR)
    eigvec = torch.as_tensor(np.array(jax_newton["eigvec"]))[None].expand(2, -1, -1).clone()
    res = BatchedModalNewton(trainer, jax_newton["peaks"], jax_newton["pws"], W.SR, 6.0,
                             1e-7).fit(*jax_newton["start"], eigvec, rounds=10)
    ref = jax_newton["res"]
    assert len(res["history"]) == 10 and np.asarray(res["iterations"]).shape == (10, 2)
    for b, t in enumerate(NEWTON_TARGETS):
        assert abs(res["E"][b] - t[1]) / t[1] < 0.03, (b, res["E"], t)
        assert abs(res["nu"][b] - t[2]) < 0.04, (b, res["nu"], t)
    np.testing.assert_allclose(res["E"], ref["E"], rtol=1e-3)
    np.testing.assert_allclose(res["nu"], ref["nu"], rtol=0, atol=1e-3)
