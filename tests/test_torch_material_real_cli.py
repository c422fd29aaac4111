"""The port's material_real CLI (`main`) on the CPU against the JAX
package's: synthetic `mic*.wav` recordings with a metadata.yaml, a fresh
run (stage 1, its cache, stage 2) and a run from the stage-1 cache, whose
stage 2 the JAX package's `main` repeats from the same cache.  The CLI's
refusal to run without a card unless asked for the CPU."""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsound_tpu.experiments import material_real as jreal
from diffsound_tpu.fem.mesh import cube_tet_mesh as jcube
from diffsound_tpu.models.sound_obj import build_model as jbuild

from diffsound_torch.audio.io import write_wav
from diffsound_torch.experiments import material_real
from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh

torch.set_num_threads(2)

SR = 32000.0


def _modal_recording(mesh, modes, T, A=2, seed=4):
    """Recordings of `mesh` at order 2 in the material (2700, 5.6e10, 0.27,
    6, 1e-7): its undamped modes damped by a linear curve, per-mic
    amplitudes, float32-rounded."""
    gt_model = jbuild(mesh=mesh, mode_num=modes, order=2, mat=(2700.0, 5.6e10, 0.27, 6.0, 1e-7),
                      task="gt", dtype=jnp.float64)
    f_und = np.asarray(gt_model.get_undamped_freqs({}, gt_model.eigen_decomposition()))
    d = 4.0 + 1e-3 * f_und
    fd = np.sqrt((2 * np.pi * f_und) ** 2 - d**2) / (2 * np.pi)
    amps = np.random.default_rng(seed).uniform(0.3, 1.0, (A, modes))
    t = (np.arange(T) + 1) / SR
    x = np.einsum("am,mt->at", amps, np.exp(-d[:, None] * t) * np.sin(2 * np.pi * fd[:, None] * t))
    return (x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def _recordings_dir(path, audio, sr):
    path.mkdir()
    for i, x in enumerate(audio):
        write_wav(str(path / f"mic{i}.wav"), 0.5 * x / np.abs(x).max(), sr)
    (path / "metadata.yaml").write_text("gain:\n- 0.0\n- 6.0\npad:\n- 0.0\n- 0.0\n")


def test_cli_fresh_then_cached_matches_jax(tmp_path):
    """`main` on the CPU: the fresh run fits stage 1 (10 steps) and writes
    its cache; a second run reads it and goes straight to stage 2.  The JAX
    package's main, given the same cache, recovers E and nu within 1e-5 of
    the port's cached run.  Stage 1's noise streams differ, so the fresh
    runs are not compared.  The JAX package's stage 2 runs in float32 and
    the port's in float64 (see tests/test_torch_material_real_stage2.py),
    and the cube's repeated modes leave each package's LOBPCG its own basis
    of a degenerate eigenspace, whose diagonal quadratic forms feed the
    Newton fit: the fits of this 4-mode recording differ by 1e-4, so E is
    held within 1e-3 and nu within 1e-3."""
    mesh = cube_tet_mesh(2)
    msh = tmp_path / "cube.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    _recordings_dir(tmp_path / "audio", _modal_recording(jcube(2), 4, 2000), 32000)
    cfg = {"sample_rate": 32000, "frame_num": 2000, "force_frame_num": 150,
           "mesh_dir": str(msh), "audio_dir": str(tmp_path / "audio"),
           "material": "Ceramic", "audio_num": 2, "mode_num": 4, "max_epoch": 1,
           "early_loss_epoch": 0, "exp_mode": 3, "gt_iters": 10,
           "out_dir": str(tmp_path / "port")}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))

    fresh = material_real.main(["--config", str(cfg_path), "--device", "cpu"])
    cache = tmp_path / "port" / "stage1_fit.npz"
    d = np.load(cache)
    assert d["freqs"].shape == d["damps"].shape == (64,)
    cached = material_real.main(["--config", str(cfg_path), "--device", "cpu"])
    for res in (fresh, cached):
        assert math.isfinite(res["youngs"]) and math.isfinite(res["poisson"])
    assert (fresh["youngs"], fresh["poisson"]) == (cached["youngs"], cached["poisson"])
    lines = (tmp_path / "port" / "result.txt").read_text().splitlines()
    assert len(lines) == 4 and lines[2].startswith("youngs:")

    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "stage1_fit.npz").write_bytes(cache.read_bytes())
    jreal.main(["--config", str(cfg_path), "--out_dir", str(tmp_path / "jax")])
    fields = dict(line.split(":", 1) for line in
                  (tmp_path / "jax" / "result.txt").read_text().splitlines())
    np.testing.assert_allclose(float(fields["youngs"]), cached["youngs"], rtol=1e-3)
    np.testing.assert_allclose(float(fields["poisson"]), cached["poisson"], rtol=0, atol=1e-3)
    assert abs(cached["youngs"] / 5.6e10 - 1) < 0.05 and abs(cached["poisson"] - 0.27) < 0.03


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"out_dir": str(tmp_path / "o"), "mesh_dir": "x.msh"}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        material_real.main(["--config", str(cfg)])
