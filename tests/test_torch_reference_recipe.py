"""The port's `reference` recipe of material_sync against the JAX package,
in f64 on a small order-2 cube: the epoch trainer with the Sinkhorn
(`geomloss`) early phase on MSSLoss([2048, 1024]), and the CLI's `reference`
recipe on the CPU.

Each geomloss step on the CPU takes seconds (four Sinkhorn divergences of
33 annealing steps on 1025- and 513-point clouds, in both packages), so the
early phase here is two epochs long, then the L1 phase runs past a refresh:
the phase switch, the optimizer reset and the refresh are what this adds to
tests/test_torch_recipes.py."""

import json
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.experiments.material_sync import MaterialSyncTask as JTask
from diffsound_tpu.models.sound_obj import build_model as jbuild

from diffsound_torch.experiments import material_sync
from diffsound_torch.experiments.material_sync import MaterialSyncTask, flagship_material_pairs
from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh

torch.set_num_threads(2)

MODES, T, SR, NF = 8, 2000, 32000.0, 150
TASK_KW = dict(mode_num=MODES, sample_rate=SR, frame_num=T, force_frame_num=NF, exp_mode=3)


def test_train_geomloss_phase_matches_jax():
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    mesh = cube_tet_mesh(3, 0.5)
    jt = JTask(mesh=mesh, **TASK_KW, dtype=jnp.float64)
    gt_audio, _ = jt.make_gt(gt_mat)
    jm = jbuild(mesh=mesh, mode_num=MODES, order=2, mat=init_mat, task="material",
                dtype=jnp.float64)
    logits = {k: np.asarray(v)
              for k, v in jm.init_params(jax.random.PRNGKey(0), pretrain=True).items()}
    kw = dict(max_epoch=17, early_loss_epoch=2, early_loss_type="geomloss",
              late_freq_weight=0.0, verbose=False, seed=0, log_every=1)
    rj = jt.train(init_mat, gt_audio, pretrain=True, **kw)
    tt = MaterialSyncTask(mesh=mesh, **TASK_KW, device="cpu")
    rt = tt.train(init_mat, torch.as_tensor(np.asarray(gt_audio)), pretrain=False,
                  init_logits=logits, **kw)
    assert rt["losses"].shape == (17,) and np.isfinite(rt["losses"]).all()
    assert len(rt["refresh_iters"]) == 1
    # the tolerances of test_torch_slice.py's 30-epoch parity test
    np.testing.assert_allclose(rt["youngs"], rj["youngs"], rtol=1e-5)
    np.testing.assert_allclose(rt["poisson"], rj["poisson"], rtol=1e-5)
    np.testing.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-4)
    assert [h["epoch"] for h in rt["history"]] == list(range(17))
    for ht, hj in zip(rt["history"], rj["history"]):
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    # the two geomloss epochs moved the material
    assert rt["history"][2]["youngs"] != rt["history"][0]["youngs"]


def test_cli_reference_recipe_on_cpu(tmp_path):
    mesh = cube_tet_mesh(2, 0.5)
    msh = tmp_path / "cube.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    out = tmp_path / "out"
    cfg = {"sample_rate": 32000, "frame_num": T, "force_frame_num": NF,
           "mesh_dir": str(msh), "mesh_name": "cube", "mode_num": MODES,
           "num_material_pairs": 1, "exp_mode": 3, "out_dir": str(out),
           "device": "cpu", "recipe": "reference", "max_epoch": 3, "early_loss_epoch": 1}
    path = tmp_path / "reference.json"
    path.write_text(json.dumps(cfg))
    material_sync.main(["--config", str(path)])
    with open(out / "result.txt") as f:
        fields = dict(line.strip().split(":", 1) for line in f if ":" in line)
    for key in ("youngs", "poisson", "RMSE"):
        assert math.isfinite(float(fields[key]))
