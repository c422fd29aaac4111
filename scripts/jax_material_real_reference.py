"""The JAX package's material_real numbers that `chip_smoke.py`'s
material_real phase is held to, on the synthetic recordings that phase
builds (`chip_smoke.synthetic_recordings`): 8 mics of the 16 modes of
`cube_tet_mesh(9, 0.3)` at order 2 in the material (2700, 5.6e10, 0.27, 6,
1e-7), damped by the damping curve of `results/r2/material_real_stage1_fit.npz`,
with noise at -40 dB of each mic's peak, max-normalised per mic.

* Stage 2's modal-Newton start: `train_material_real` with no epochs, from
  MatSet.Ceramic with that curve; the (E, nu) of its `ModalNewtonFitter.fit`.
* Stage 1's loss fall: `fit_gt_oscillator` (256 modes, 8000 samples, float32)
  for --iters steps; the 5-scale L1 loss at its seeded start and at its end.

Run on the CPU (the JAX package, not the port), from the repository root:

    JAX_PLATFORMS=cpu python -m scripts.jax_material_real_reference --iters 300

It prints the Newton fit's rounds as it goes, then one JSON line; its
`undamped_freqs` are `chip_smoke.REAL_GT_FREQS`."""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from diffsound_tpu.audio.damping import DampingCurve
from diffsound_tpu.audio.mss_loss import MSSLoss
from diffsound_tpu.experiments.material_real import fit_gt_oscillator, train_material_real
from diffsound_tpu.fem.material import Material, MatSet
from diffsound_tpu.fem.mesh import cube_tet_mesh
from diffsound_tpu.models import modal_fit
from diffsound_tpu.models.sound_obj import build_model


def stage1_loss(bank, params, audio, key):
    """The stage-1 step's loss at `params`, its noise drawn from `key`."""
    forces = jnp.zeros((audio.shape[0], 150), jnp.float32).at[:, 0].set(1.0)
    sig, _ = bank(params, forces, noise_rate=2e-4, key=key)
    return float(MSSLoss([512, 256, 128, 64, 32], chip_smoke.SR, loss_type="l1_loss")(sig, audio))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=9, help="cube_tet_mesh cells per edge")
    ap.add_argument("--iters", type=int, default=300, help="stage-1 steps")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    t0 = time.perf_counter()
    mesh = cube_tet_mesh(args.n, 0.3)
    gt_model = build_model(mesh=mesh, mode_num=16, order=2, mat=chip_smoke.REAL_TARGET,
                           task="gt", dtype=jnp.float64)
    f_und = np.asarray(gt_model.get_undamped_freqs({}, gt_model.eigen_decomposition()))
    curve = DampingCurve(*chip_smoke.r2_curve_data())
    audio = chip_smoke.synthetic_recordings(f_und, np.asarray(curve(f_und)))
    fits, fit = [], modal_fit.ModalNewtonFitter.fit

    def recording_fit(self, *a, **kw):
        fits.append(fit(self, *a, **kw))
        return fits[-1]

    modal_fit.ModalNewtonFitter.fit = recording_fit
    train_material_real(mesh, audio, curve, Material.of(MatSet.Ceramic), max_epoch=0,
                        early_loss_epoch=0, verbose=True)
    newton_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    audio32 = jnp.asarray(audio, jnp.float32)
    forces = jnp.zeros((audio.shape[0], 150), jnp.float32).at[:, 0].set(1.0)
    bank, params = fit_gt_oscillator(audio32, forces, 256, chip_smoke.SR,
                                     Material.of(MatSet.Ceramic), iters=args.iters)
    start = bank.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(12345)
    loss0, loss_end = (stage1_loss(bank, p, audio32, key) for p in (start, params))
    print(json.dumps({"n": args.n, "dof": 3 * (2 * args.n + 1) ** 3,
                      "undamped_freqs": f_und.tolist(), "newton_E": fits[0]["E"],
                      "newton_nu": fits[0]["nu"], "newton_s": newton_s,
                      "stage1_iters": args.iters, "stage1_loss_start": loss0,
                      "stage1_loss_end": loss_end,
                      "stage1_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
