"""The port's numpy threefry PRNG (`diffsound_torch/utils/prng.py`) against
`jax.random` under the JAX package's settings (x64 on, partitionable
threefry): keys, splits, 64-bit words and float64 uniforms bit for bit;
the random material pairs exactly for any n; the 16 flagship pairs
(tests/flagship_pairs.json, the table the port kept before it drew them) as
a regression anchor; and the pair list the material_sync CLI trains at 20
pairs, serial and parallel."""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax

import diffsound_tpu  # noqa: F401  (turns x64 on, as the JAX package runs)
from diffsound_tpu.experiments.material_sync import random_material_pairs as jax_pairs

from diffsound_torch.experiments import material_sync
from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh
from diffsound_torch.utils import prng

torch.set_num_threads(2)

ANCHOR = pathlib.Path(__file__).with_name("flagship_pairs.json")
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / "material_sync_train.json"
SEEDS = [0, 1, 42, 123456789, 2**40 + 5, -1]
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 5)]


def _anchor():
    return [tuple(tuple(m) for m in pair) for pair in json.loads(ANCHOR.read_text())]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_are_jax_bit_for_bit(seed):
    key = prng.PRNGKey(seed)
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for n in (1, 2, 4, 9):
        np.testing.assert_array_equal(prng.split(key, n),
                                      np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)))
    # a split of a split
    np.testing.assert_array_equal(
        prng.split(prng.split(key)[1], 3),
        np.asarray(jax.random.split(jax.random.split(jax.random.PRNGKey(seed))[1], 3)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniforms_and_bits_are_jax_bit_for_bit(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    got = prng.uniform(key, shape)
    want = np.asarray(jax.random.uniform(jkey, shape))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(prng.random_bits(key, shape),
                                  np.asarray(jax.random.bits(jkey, shape, np.uint64)))


@pytest.mark.parametrize("n", [1, 5, 16, 20, 64])
def test_random_material_pairs_equal_jax_exactly(n):
    got = material_sync.random_material_pairs(prng.PRNGKey(0), n)
    assert got == jax_pairs(jax.random.PRNGKey(0), n)
    assert material_sync.flagship_material_pairs(n) == got


def test_flagship_pairs_keep_the_anchor_and_are_prefix_stable():
    anchor = _anchor()
    assert len(anchor) == 16
    assert material_sync.flagship_material_pairs(20)[:16] == anchor
    assert material_sync.flagship_material_pairs(16) == anchor
    assert material_sync.random_material_pairs(prng.PRNGKey(7), 3) == \
        jax_pairs(jax.random.PRNGKey(7), 3)


class _Task:
    """Stands in for MaterialSyncTask: trains nothing, returns each pair's
    init material as its result."""

    def __init__(self, **kw):
        pass

    def make_gt(self, gt_mat):
        return None, None

    def train_newton(self, init_mat, gt_audio, **kw):
        return {"youngs": init_mat[1], "poisson": init_mat[2], "rmse": 0.0,
                "iters_per_sec": 1.0, "wall_s": 0.0}


def _results(path):
    lines = path.read_text().splitlines()
    get = lambda tag: [float(x.split(":", 1)[1]) for x in lines if x.startswith(tag + ":")]
    return get("youngs"), get("poisson"), get("target youngs"), get("target poisson")


@pytest.mark.parametrize("parallel", [False, True])
def test_cli_trains_the_jax_pairs_at_20(tmp_path, monkeypatch, parallel):
    """The CLI at num_material_pairs 20 (it raised above 16 while the pairs
    came from a fixed table): the pairs it hands on, serial and parallel,
    are the JAX package's draw.  The training and the logger are stubbed."""
    seen = {}

    def parallel_stub(task, pairs, flags, logger):
        seen["pairs"] = pairs
        return {"youngs": [p[0][1] for p in pairs], "poisson": [p[0][2] for p in pairs],
                "pair_iters_per_sec": 1.0}

    monkeypatch.setattr(material_sync, "MaterialSyncTask", _Task)
    monkeypatch.setattr(material_sync, "MetricLogger", lambda out_dir: None)
    monkeypatch.setattr(material_sync, "train_pairs_parallel", parallel_stub)
    monkeypatch.setattr("diffsound_torch.parallel.mesh.init_distributed", lambda device: (0, 1))
    mesh = cube_tet_mesh(1)
    write_msh(str(tmp_path / "c.msh"), mesh.vertices, mesh.tets)
    out = tmp_path / "out"
    material_sync.main(["--config", str(CONFIG),
                        "--mesh_dir", str(tmp_path / "c.msh"), "--out_dir", str(out),
                        "--device", "cpu", "--num_material_pairs", "20",
                        "--parallel", str(parallel).lower()])
    want = jax_pairs(jax.random.PRNGKey(0), 20)
    if parallel:
        assert seen["pairs"] == want
    youngs, poisson, t_youngs, t_poisson = _results(out / "result.txt")
    assert youngs == [p[0][1] for p in want] and poisson == [p[0][2] for p in want]
    assert t_youngs == [p[1][1] for p in want] and t_poisson == [p[1][2] for p in want]
