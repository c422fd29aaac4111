"""The port's material_sync recipes against the JAX package, in f64 on a
small order-2 cube: the epoch trainer with the freq-chamfer early phase and
the late auxiliary, the modal-Newton recipe (fit and polish), and the CLI's
`newton` and `adam` recipes on the CPU.  The `reference` (Sinkhorn) recipe
is in tests/test_torch_reference_recipe.py."""

import json
import math

import numpy as np
import pytest
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


def _pair0(mesh):
    """Flagship pair 0 on `mesh`: JAX's ground truth and JAX's pretrained
    start from PRNGKey(0), the start the epoch trainer takes."""
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    jt = JTask(mesh=mesh, **TASK_KW, dtype=jnp.float64)
    gt_audio, _ = jt.make_gt(gt_mat)
    jm = jbuild(mesh=mesh, mode_num=MODES, order=2, mat=init_mat, task="material",
                dtype=jnp.float64)
    logits = {k: np.asarray(v)
              for k, v in jm.init_params(jax.random.PRNGKey(0), pretrain=True).items()}
    tt = MaterialSyncTask(mesh=mesh, **TASK_KW, device="cpu")
    return dict(init_mat=init_mat, gt_mat=gt_mat, jt=jt, tt=tt, gt_audio=gt_audio,
                gt_t=torch.as_tensor(np.asarray(gt_audio)), logits=logits)


@pytest.fixture(scope="module")
def pair0():
    return _pair0(cube_tet_mesh(3, 0.5))


@pytest.fixture(scope="module")
def pair0_small():
    """The modal-Newton recipe runs dozens of f64 eigensolves (up to 300
    LOBPCG iterations each), so it gets the smaller cube."""
    return _pair0(cube_tet_mesh(2, 0.5))


def _assert_runs_agree(rt, rj):
    """The tolerances of test_torch_slice.py's 30-epoch parity test."""
    np.testing.assert_allclose(rt["youngs"], rj["youngs"], rtol=1e-5)
    np.testing.assert_allclose(rt["poisson"], rj["poisson"], rtol=1e-5)
    np.testing.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-4)
    assert [h["epoch"] for h in rt["history"]] == [h["epoch"] for h in rj["history"]]
    for ht, hj in zip(rt["history"], rj["history"]):
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)


def test_train_freq_chamfer_phase_and_auxiliary_match_jax(pair0):
    """15 freq-chamfer epochs, the optimizer reset, then 15 epochs of L1 plus
    300 x chamfer; two eigensolves (one cold, one warm refresh)."""
    kw = dict(max_epoch=30, early_loss_epoch=15, early_loss_type="freq_chamfer",
              late_freq_weight=300.0, verbose=False, seed=0)
    rj = pair0["jt"].train(pair0["init_mat"], pair0["gt_audio"], pretrain=True, **kw)
    rt = pair0["tt"].train(pair0["init_mat"], pair0["gt_t"], pretrain=False,
                           init_logits=pair0["logits"], **kw)
    assert rt["losses"].shape == (30,) and np.isfinite(rt["losses"]).all()
    assert len(rt["refresh_iters"]) == 1
    _assert_runs_agree(rt, rj)
    # the chamfer phase moved E toward the target
    start = pair0["init_mat"][1]
    assert abs(rt["youngs"] - pair0["gt_mat"][1]) < abs(start - pair0["gt_mat"][1])


def test_train_newton_matches_jax(pair0_small):
    pair0 = pair0_small
    kw = dict(rounds=3, polish_epochs=20, verbose=False, seed=0)
    rj = pair0["jt"].train_newton(pair0["init_mat"], pair0["gt_audio"], **kw)
    rt = pair0["tt"].train_newton(pair0["init_mat"], pair0["gt_t"], **kw)
    np.testing.assert_allclose(rt["newton_E"], rj["newton_E"], rtol=1e-6)
    np.testing.assert_allclose(rt["newton_nu"], rj["newton_nu"], rtol=1e-6)
    assert rt["fit_rounds"] == rj["fit_rounds"]
    _assert_runs_agree(rt, rj)
    assert rt["losses"].shape == (20,) and np.isfinite(rt["losses"]).all()
    fit = rt["fit"]
    assert [w["window"] for w in fit["windows"]] == ["hann", "blackmanharris", "blackmanharris"]
    # one cold solve for the first window; every later solve is warm,
    # carried from window to window
    assert sum(not s["warm"] for s in fit["solves"]) == 1 and not fit["solves"][0]["warm"]
    assert fit["wall_s"] > 0 and rt["wall_s"] > fit["wall_s"]
    gt_mat = pair0["gt_mat"]
    print(f"newton on cube_tet_mesh(2, 0.5): E {rt['newton_E']:.6g} (target {gt_mat[1]:.6g}), "
          f"nu {rt['newton_nu']:.5f} (target {gt_mat[2]:.5f}); after the polish "
          f"E {rt['youngs']:.6g} nu {rt['poisson']:.5f}")


def test_train_newton_without_polish(pair0_small):
    pair0 = pair0_small
    rt = pair0["tt"].train_newton(pair0["init_mat"], pair0["gt_t"], rounds=1,
                                  polish_epochs=0, verbose=False)
    assert rt["youngs"] == rt["newton_E"] and math.isnan(rt["rmse"])


def _cli(tmp_path, recipe, **cfg):
    mesh = cube_tet_mesh(2, 0.5)
    msh = tmp_path / "cube.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    out = tmp_path / recipe
    cfg = {"sample_rate": 32000, "frame_num": T, "force_frame_num": NF,
           "mesh_dir": str(msh), "mesh_name": "cube", "mode_num": MODES,
           "num_material_pairs": 1, "exp_mode": 3, "out_dir": str(out),
           "device": "cpu", "recipe": recipe, **cfg}
    path = tmp_path / f"{recipe}.json"
    path.write_text(json.dumps(cfg))
    material_sync.main(["--config", str(path)])
    with open(out / "result.txt") as f:
        return dict(line.strip().split(":", 1) for line in f if ":" in line)


@pytest.mark.parametrize("recipe,cfg", [
    ("newton", {"newton_rounds": 1, "polish_epochs": 3}),
    ("adam", {"max_epoch": 6, "early_loss_epoch": 3}),
])
def test_cli_recipe_on_cpu(tmp_path, recipe, cfg):
    fields = _cli(tmp_path, recipe, **cfg)
    assert math.isfinite(float(fields["youngs"])) and math.isfinite(float(fields["poisson"]))
    assert math.isfinite(float(fields["RMSE"]))


def test_cli_default_recipe_is_newton_and_unknown_raises(tmp_path, monkeypatch):
    called = []
    monkeypatch.setattr(MaterialSyncTask, "train_newton",
                        lambda self, *a, **k: called.append(k) or
                        {"youngs": 1.0, "poisson": 0.2, "rmse": 0.0, "iters_per_sec": 1.0})
    cfg = {"newton_rounds": 1, "polish_epochs": 1}
    mesh = cube_tet_mesh(1)
    msh = tmp_path / "c.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"mesh_dir": str(msh), "out_dir": str(tmp_path / "o"),
                                "device": "cpu", "mode_num": 2, "frame_num": 500,
                                "sample_rate": 32000, "force_frame_num": 10,
                                "exp_mode": 3, "num_material_pairs": 1, **cfg}))
    material_sync.main(["--config", str(path)])
    assert called and called[0]["rounds"] == 1 and called[0]["polish_epochs"] == 1
    with pytest.raises(ValueError, match="recipe"):
        material_sync.main(["--config", str(path), "--recipe", "sgd"])
