"""The port's thickness and morphing CLIs on the CPU at grid 8 against the
JAX package's: the Gauss-Newton optimizer recovers the same coefficients
and writes the same result lines; the Adam optimizer (warm solves) runs,
writes its lines and, for thickness, the recovered surface as an OBJ."""

import json

import numpy as np
import pytest
import torch

from diffsound_tpu.experiments import morphing as jmorphing
from diffsound_tpu.experiments import thickness as jthickness

from diffsound_torch.experiments import morphing, thickness
from diffsound_torch.fem.mesh import icosphere, read_obj, write_obj

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    v, f = icosphere(2, radius=0.42)
    write_obj(str(d / "ball.obj"), v, f)
    write_obj(str(d / "egg.obj"), v * np.array([0.95, 0.7, 0.8]), f)
    return d


def _config(path, meshes, out_dir, task, optimizer, device=None, eig_method="warm"):
    cfg = {"iter": 3, "out_dir": str(out_dir), "init_mesh_dir": str(meshes),
           "mesh_scale": 1.0, "dmtet_grid": 8, "mat": "Steel", "mode_num": 6,
           "optimizer": optimizer, "eig_method": eig_method}
    if task == "thickness":
        cfg.update(mesh_name="ball", thickness_list=[0.6], learning_rate=5e-2)
    else:
        cfg.update(mesh_name1="ball", mesh_name2="egg", morphing_list=[0.7], learning_rate=1e-1)
    if device:
        cfg["device"] = device
    path.write_text(json.dumps(cfg))
    return ["--config", str(path)]


def _lines(path):
    rows = [ln.split() for ln in path.read_text().splitlines()]
    return {r[0].split(":")[1]: dict(kv.split(":") for kv in r) for r in rows
            if r[0].startswith("target:")}, rows


@pytest.mark.parametrize("task", ["thickness", "morphing"])
def test_newton_cli_matches_jax(tmp_path, meshes, task):
    """Both packages' CLIs, the newton optimizer with host eigensolves (the
    JAX package's warm solver compiles per mesh bucket, a minute of this
    test; the port's warm solves are held to ARPACK in
    test_torch_shape_warm_eigs.py and on the card): the recovered
    coefficient within 1e-7 of the JAX package's, within 0.02 of the
    target, and the same result-file layout."""
    mods = {"thickness": (jthickness, thickness), "morphing": (jmorphing, morphing)}[task]
    name = "result_ball.txt" if task == "thickness" else "result_ball_egg.txt"
    got = {}
    for pkg, mod in zip(("jax", "torch"), mods):
        out = tmp_path / pkg
        mod.main(_config(tmp_path / f"{pkg}.json", meshes, out, task, "newton",
                         "cpu" if pkg == "torch" else None, eig_method="host"))
        got[pkg] = _lines(out / name)
    (tj, rows_j), (tt, rows_t) = got["jax"], got["torch"]
    assert tj.keys() == tt.keys() and len(tt) == 1
    for key in tt:
        assert float(tt[key]["result"]) == pytest.approx(float(tj[key]["result"]), abs=1e-7)
        assert abs(float(tt[key]["result"]) - float(key)) < 0.02
        assert tt[key].keys() == tj[key].keys()
    assert [r[0].split(":")[0] for r in rows_t] == [r[0].split(":")[0] for r in rows_j]


@pytest.mark.parametrize("task", ["thickness", "morphing"])
def test_adam_cli_runs_and_writes_its_results(tmp_path, meshes, task):
    out = tmp_path / "out"
    mod = thickness if task == "thickness" else morphing
    results = mod.main(_config(tmp_path / "c.json", meshes, out, task, "adam", "cpu"))
    (target, result), = results
    assert np.isfinite(result) and 0.0 < result < 1.0
    name = "result_ball.txt" if task == "thickness" else "result_ball_egg.txt"
    lines, rows = _lines(out / name)
    assert float(lines[str(target)]["result"]) == result
    assert rows[-1][0].startswith("total") and (out / "metrics.jsonl").exists()
    if task == "thickness":
        v, f = read_obj(str(out / "ball" / f"result{target}.obj"))
        assert len(f) > 100 and np.isfinite(v).all() and f.max() < len(v)
