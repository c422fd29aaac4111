"""The float32-against-float64 gap of one geomloss step at the flagship
width, per seed: the JAX package's own, which chip_smoke.py holds the card's
float32 step to (chip_smoke.JAX_GEOMLOSS_F32_GAP), and the port's on the CPU
against it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from test_torch_sinkhorn import _jax_geomloss, _modal_pair

torch.set_num_threads(2)


def _gap(v32, g32, v64, g64):
    """(relative loss gap, relative error of the frequency gradient)."""
    g32, g64 = np.asarray(g32, np.float64), np.asarray(g64, np.float64)
    return abs(v32 / v64 - 1), float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))


def _jax_gap(seed):
    f_tgt, f_pred = _modal_pair(8000, seed=seed)
    v64, g64, _ = _jax_geomloss([2048, 1024], 8000, f_tgt, f_pred, jnp.float64)
    v32, g32, _ = _jax_geomloss([2048, 1024], 8000, f_tgt.astype(np.float32),
                                f_pred.astype(np.float32), jnp.float32)
    assert np.isfinite(v32) and np.isfinite(g32).all()
    return _gap(v32, g32, v64, g64)


@pytest.mark.parametrize("seed", chip_smoke.GEOMLOSS_SEEDS)
def test_jax_geomloss_float32_gap(seed):
    """The JAX package's geomloss step (synthesis, MSSLoss([2048, 1024])
    geomloss, gradient to the undamped frequencies) at the flagship width,
    16 modes and 8000 samples, in float32 against float64 on the CPU, at
    each seed of chip_smoke.GEOMLOSS_SEEDS: the readings are the table
    chip_smoke.py gates the card with (four significant digits).  Run with
    -s to see them."""
    assert tuple(chip_smoke.JAX_GEOMLOSS_F32_GAP) == chip_smoke.GEOMLOSS_SEEDS
    gap, err = _jax_gap(seed)
    print(f"JAX geomloss step, seed {seed}, float32 against float64: relative loss gap "
          f"{gap:.3e}, gradient relative error {err:.3e}")
    np.testing.assert_allclose((gap, err), chip_smoke.JAX_GEOMLOSS_F32_GAP[seed], rtol=5e-3)


def _port_step(seed, dtype):
    """chip_smoke.geomloss_standin on the CPU: (loss, frequency gradient)."""
    return chip_smoke.geomloss_standin(seed, torch.device("cpu"), dtype)


@pytest.mark.parametrize("seed", chip_smoke.GEOMLOSS_SEEDS[:3])
def test_port_geomloss_float32_gap_within_jax_margin(seed):
    """The port's float32 geomloss step on the CPU against its float64, at
    the card's seeded steps, inside the card's gate there
    (chip_smoke.geomloss_gate).  It reads 0.84-2.22 times JAX's loss gap and
    0.38-3.11 times its gradient error over the ten seeds (-s prints it)."""
    v32, g32 = _port_step(seed, torch.float32)
    v64, g64 = _port_step(seed, torch.float64)
    gap, err = _gap(v32, g32.numpy(), v64, g64.numpy())
    jax_gap, jax_err = chip_smoke.JAX_GEOMLOSS_F32_GAP[seed]
    print(f"port geomloss step, seed {seed}, float32 against float64 on the CPU: relative "
          f"loss gap {gap:.3e} (JAX {jax_gap:.3e}), gradient relative error {err:.3e} "
          f"(JAX {jax_err:.3e})")
    gate = chip_smoke.geomloss_gate(seed)
    assert gap <= gate[0] and err <= gate[1]
