"""Guards of the PyTorch port: it never imports JAX (nor flax, optax,
imageio or the JAX package), it never runs on the CPU unless asked, its CUDA synthesis never falls back to the plain version, and
its flagship material pairs are the JAX package's draw."""

import ast
import inspect
import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from diffsound_tpu.experiments.material_sync import random_material_pairs

from diffsound_torch.audio import synth_kernel
from diffsound_torch.audio.mss_loss import spec_to_points
from diffsound_torch.audio.oscillator import synth_constant_modes
from diffsound_torch.experiments import material_sync
from diffsound_torch.experiments.material_real import fit_gt_oscillator, train_material_real
from diffsound_torch.experiments.material_sync import MaterialSyncTask, flagship_material_pairs
from diffsound_torch.acoustics import BEMModel
from diffsound_torch.experiments import geometry, joint, morphing, thickness
from diffsound_torch.fem.assembly import FEMOperators
from diffsound_torch.fem.mesh import cube_tet_mesh, icosphere, write_msh, write_obj
from diffsound_torch.geometry.dlmesh import DLMesh
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.geometry_task import GeometryTask
from diffsound_torch.geometry.joint_task import JointImageAudioTask, SplitSDFGeometry
from diffsound_torch.geometry.sdf_mlp import SDFGeometry
from diffsound_torch.geometry.sdf_host import mesh_signed_distance
from diffsound_torch.geometry.tasks import MorphingTask, ShapeTaskBase, ThicknessTask
from diffsound_torch.geometry.warm_eigs import WarmShapeEigensolver
from diffsound_torch.models.sound_obj import DiffSoundObject, build_model
from diffsound_torch.render.light import EnvironmentLight
from diffsound_torch.render.mesh import Mesh
from diffsound_torch.render.mlptexture import MLPTexture3D

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imageio", "diffsound_tpu")


def _port_sources():
    return sorted((ROOT / "diffsound_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    sources = _port_sources()
    assert len(sources) > 20
    names = {str(p.relative_to(ROOT)) for p in sources}
    assert {"diffsound_torch/geometry/sdf_mlp.py", "diffsound_torch/geometry/geometry_task.py",
            "diffsound_torch/experiments/geometry.py", "diffsound_torch/acoustics/bem.py",
            "diffsound_torch/fem/transform.py", "diffsound_torch/render/rasterize.py",
            "diffsound_torch/render/light.py", "diffsound_torch/geometry/joint_task.py",
            "diffsound_torch/geometry/dlmesh.py", "diffsound_torch/experiments/joint.py"} <= names
    bad = [
        f"{p.relative_to(ROOT)}: {m}"
        for p in sources for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


@pytest.mark.parametrize("entry", [build_model, DiffSoundObject.__init__, MaterialSyncTask,
                                   fit_gt_oscillator, train_material_real,
                                   ShapeTaskBase.__init__, MarchingTets.__init__,
                                   WarmShapeEigensolver.__init__, mesh_signed_distance,
                                   GeometryTask.__init__, SDFGeometry.__init__,
                                   FEMOperators.__init__, BEMModel.__init__,
                                   JointImageAudioTask.__init__, SplitSDFGeometry.__init__,
                                   DLMesh.__init__])
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = cube_tet_mesh(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(mesh=mesh, mode_num=2, order=1, task="material")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaterialSyncTask(mesh=mesh, mode_num=2)
    # asked for explicitly, the CPU runs (in float64)
    assert build_model(mesh=mesh, mode_num=2, order=1, device="cpu").dtype == torch.float64


@pytest.mark.parametrize("recipe", ["newton", "adam", "reference"])
def test_cli_recipes_raise_without_cuda(tmp_path, monkeypatch, recipe):
    """The CLI, whatever its recipe, runs on the card unless the config
    says "device": "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = cube_tet_mesh(1)
    msh = tmp_path / "c.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"mesh_dir": str(msh), "out_dir": str(tmp_path / "o"),
                               "mode_num": 2, "sample_rate": 32000, "frame_num": 500,
                               "force_frame_num": 10, "exp_mode": 3, "recipe": recipe}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        material_sync.main(["--config", str(cfg)])


@pytest.mark.parametrize("task", [ThicknessTask, MorphingTask])
def test_shape_tasks_raise_without_cuda(monkeypatch, task):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        task(grid_res=2, scale=1.0, mat="Steel", mode_num=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_signed_distance(np.zeros((2, 3)), *icosphere(0))
    assert task(grid_res=2, scale=1.0, mat="Steel", mode_num=2, device="cpu").dtype == torch.float64


def test_geometry_and_leftovers_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeometryTask(grid_res=2, mode_num=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FEMOperators(cube_tet_mesh(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BEMModel(*icosphere(0), 500.0)
    assert GeometryTask(grid_res=2, mode_num=2, device="cpu").dtype == torch.float64
    assert FEMOperators(cube_tet_mesh(1), device="cpu").dtype == torch.float64
    assert BEMModel(*icosphere(0), 500.0, device="cpu").dtype == torch.float64


def test_geometry_cli_raises_without_cuda(tmp_path, monkeypatch):
    """The geometry CLI runs on the card unless the config says
    "device": "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = cube_tet_mesh(2, 0.5)
    write_msh(str(tmp_path / "a.msh"), mesh.vertices, mesh.tets)
    write_obj(str(tmp_path / "a_surf.obj"), *icosphere(1, 0.3))
    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps({
        "init_mesh_dir": str(tmp_path), "mesh_name_list": ["a"], "mode_num_list": [2],
        "voxel_num_list": [4], "grid_res": 4, "freq_num": 1, "iter": 1,
        "learning_rate": 1e-4, "out_dir": str(tmp_path / "o")}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        geometry.main(["--config", str(cfg)])


def test_joint_task_dlmesh_and_joint_cli_raise_without_cuda(tmp_path, monkeypatch):
    """The joint task, DLMesh and the joint CLI run on the card unless asked
    for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JointImageAudioTask(grid_res=2, mode_num=2, hidden_dim=4, light_res=8)
    v, f = icosphere(0, 0.5)
    base = Mesh(v_pos=torch.as_tensor(v, dtype=torch.float32), t_pos_idx=torch.as_tensor(f))
    material = {"kd_ks_normal": MLPTexture3D((np.full(3, -1.0), np.full(3, 1.0))), "bsdf": "pbr"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DLMesh(base, EnvironmentLight(16), material)
    cfg = ["--config", "configs/joint_train.json", "--grid_res", "2", "--resolution", "8",
           "--out_dir", str(tmp_path / "o"), "--iter", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        joint.main(cfg)
    task = JointImageAudioTask(grid_res=2, mode_num=2, hidden_dim=4, light_res=8, device="cpu")
    assert task.dtype == torch.float32 and task.warm.dtype == torch.float64
    assert DLMesh(base, EnvironmentLight(16), material, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cli", [thickness, morphing])
def test_shape_clis_raise_without_cuda(tmp_path, monkeypatch, cli):
    """Both shape CLIs, either optimizer, run on the card unless the config
    says "device": "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_obj(str(tmp_path / "a.obj"), *icosphere(1, 0.3))
    for optimizer in ("adam", "newton"):
        cfg = tmp_path / "c.json"
        cfg.write_text(json.dumps({
            "init_mesh_dir": str(tmp_path), "mesh_name": "a", "mesh_name1": "a",
            "mesh_name2": "a", "out_dir": str(tmp_path / "o"), "mesh_scale": 1.0,
            "dmtet_grid": 4, "thickness_list": [0.5], "morphing_list": [0.5], "iter": 1,
            "learning_rate": 0.01, "mode_num": 2, "optimizer": optimizer}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--config", str(cfg)])


def test_spec_to_points_is_deterministic():
    """Two modes in one bin and one above Nyquist: the bins' writes are
    resolved by a fixed rule, so repeated calls agree bit for bit."""
    spec = torch.rand((1, 129, 5), generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    freqs = torch.tensor([1000.0, 1004.0, 15950.0, 17500.0], dtype=torch.float64)
    first = spec_to_points(spec, freqs, 32000.0)
    assert all(torch.equal(first, spec_to_points(spec, freqs, 32000.0)) for _ in range(3))


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach the dispatch's
    CUDA branch on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_synthesis_of_float64_raises_and_never_falls_back():
    x = torch.ones(1, 4, dtype=torch.float64).as_subclass(_CudaLooking)
    before = synth_kernel.LAUNCHES
    with pytest.raises(TypeError, match="float32"):
        synth_constant_modes(x, x, x, 100, 32000.0)
    assert synth_kernel.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 4, 16])
def test_flagship_pairs_are_the_jax_draw(n):
    want = random_material_pairs(jax.random.PRNGKey(0), n)
    got = flagship_material_pairs(n)
    assert len(got) == n
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(gt), np.asarray(wt))
