"""The JAX package's parallel multi-pair trainer and batched modal-Newton fit
on the cube the port's chip_smoke.py parallel phase uses: all 16 flagship
pairs at the flagship widths (16 modes, 8000 samples at 32 kHz, order 2,
exp_mode 3) on `cube_tet_mesh(n, 0.3)`.

It writes one .npz that the port's chip script reads (it never runs JAX):

* `init_youngs_logits`, `init_poisson_logits` (16, 16) float32:
  `MultipairTrainer.init(PRNGKey(0), 16)`'s pretrained bins;
* `traj_losses` (steps, 16): the float32 trainer's L1 losses over `--steps`
  steps from that start, a warm refresh every 15 (`train_pairs_parallel`'s
  schedule, lr 2e-3), and `traj_E`, `traj_nu` (16,) after them;
* `newton_E_f32`, `newton_nu_f32`, `newton_E_f64`, `newton_nu_f64` (16,):
  `BatchedModalNewton.fit` over `--rounds` rounds in each dtype, every pair
  from its own init material and the cold basis at pair 0's init material,
  on the peaks of that dtype's ground truth;
* `target_E`, `target_nu` (16,), the mesh's `dof`, and each part's seconds.

Run on the CPU (the JAX package, not the port; about 10 minutes):

    JAX_PLATFORMS=cpu python -m scripts.jax_parallel_reference \\
        --out results/parallel/jax_batched_newton.npz
"""

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from diffsound_tpu.audio.freq_loss import extract_spectral_peaks
from diffsound_tpu.audio.oscillator import TraditionalOscillatorParams
from diffsound_tpu.experiments.material_sync import (
    EIGEN_DECOMPOSE_CYCLE, MaterialSyncTask, impulse_forces, random_material_pairs,
)
from diffsound_tpu.fem.material import Material, lame_params
from diffsound_tpu.fem.mesh import cube_tet_mesh
from diffsound_tpu.models.sound_obj import build_model
from diffsound_tpu.parallel.mesh import make_device_mesh
from diffsound_tpu.parallel.newton import BatchedModalNewton
from diffsound_tpu.parallel.train import MultipairTrainer


def setup(pairs, n, dtype):
    """The task, its ground truths, the trainer on a (1, 1) mesh and the
    cold basis at pair 0's init material, as `train_pairs_parallel` builds
    them."""
    task = MaterialSyncTask(mesh=cube_tet_mesh(n, 0.3), mode_num=16, sample_rate=32000.0,
                            frame_num=8000, force_frame_num=150, exp_mode=3, dtype=dtype)
    init_mat = pairs[0][0]
    model = build_model(mesh=task.mesh, mode_num=task.mode_num, order=task.mesh_order,
                        mat=init_mat, task=task.task, dtype=dtype)
    osc = TraditionalOscillatorParams(1, task.mode_num, task.frame_num, task.sample_rate,
                                      Material.of(init_mat))
    trainer = MultipairTrainer(
        bins=model.bins, ops=model.ops, osc=osc, mesh=make_device_mesh(1, 1),
        forces=impulse_forces(1, task.force_frame_num, dtype), sample_rate=task.sample_rate,
        lr=2e-3,
    )
    gt = jnp.stack([task.make_gt(g)[0] for _, g in pairs])
    eig0 = model.eigen_decomposition(method="arpack")
    return task, model, trainer, gt, eig0


def newton(pairs, task, model, trainer, gt, eig0, rounds):
    peaks, pws = [], []
    for b in range(len(pairs)):
        pk, pw = extract_spectral_peaks(np.asarray(gt[b]), task.sample_rate)
        peaks.append(pk)
        pws.append(pw)
    init_mat = pairs[0][0]
    fitter = BatchedModalNewton(trainer, peaks, pws, task.sample_rate, init_mat[3], init_mat[4])
    lame = np.array([lame_params(i[1] / i[0], i[2]) for i, _ in pairs])
    B = len(pairs)
    eigvec_b = jnp.stack([eig0.eigenvectors.astype(task.dtype)] * B)
    res = fitter.fit(lame[:, 0], lame[:, 1], eigvec_b, rounds=rounds, verbose=True)
    return res["E"], res["nu"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=6, help="cube_tet_mesh cells per edge")
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--out", default="results/parallel/jax_batched_newton.npz")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    pairs = random_material_pairs(jax.random.PRNGKey(0), args.pairs)
    B = len(pairs)
    out = {"target_E": np.array([g[1] for _, g in pairs]),
           "target_nu": np.array([g[2] for _, g in pairs]),
           "n": args.n, "dof": 3 * (2 * args.n + 1) ** 3, "steps": args.steps,
           "rounds": args.rounds}

    t0 = time.perf_counter()
    task, model, trainer, gt, eig0 = setup(pairs, args.n, jnp.float32)
    out["setup_f32_s"] = time.perf_counter() - t0
    params_b, opt_b = trainer.init(jax.random.PRNGKey(0), B)
    out["init_youngs_logits"] = np.asarray(params_b["youngs_logits"])
    out["init_poisson_logits"] = np.asarray(params_b["poisson_logits"])
    eigval_b = jnp.stack([eig0.eigenvalues.astype(jnp.float32)] * B)
    eigvec_b = jnp.stack([eig0.eigenvectors.astype(jnp.float32)] * B)
    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        params_b, opt_b, loss_b, eigval_b, eigvec_b = trainer.step(
            params_b, opt_b, eigval_b, eigvec_b, gt,
            refresh=(step % EIGEN_DECOMPOSE_CYCLE == 0 and step > 0),
        )
        losses.append(np.asarray(loss_b))
        print(f"step {step}: mean loss {losses[-1].mean():.6f}", flush=True)
    out["traj_s"] = time.perf_counter() - t0
    out["traj_losses"] = np.stack(losses)
    out["traj_E"] = np.asarray(jax.vmap(model.bins.youngs)(params_b))
    out["traj_nu"] = np.asarray(jax.vmap(model.bins.poisson)(params_b))

    t0 = time.perf_counter()
    out["newton_E_f32"], out["newton_nu_f32"] = newton(pairs, task, model, trainer, gt, eig0,
                                                       args.rounds)
    out["newton_f32_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup64 = setup(pairs, args.n, jnp.float64)
    out["newton_E_f64"], out["newton_nu_f64"] = newton(pairs, *setup64, args.rounds)
    out["newton_f64_s"] = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out)
    for b in range(B):
        print(f"pair {b}: newton f32 E {out['newton_E_f32'][b]:.6g} nu "
              f"{out['newton_nu_f32'][b]:.5f}, f64 E {out['newton_E_f64'][b]:.6g} nu "
              f"{out['newton_nu_f64'][b]:.5f}; target E {out['target_E'][b]:.6g} nu "
              f"{out['target_nu'][b]:.5f}; 60-step loss {out['traj_losses'][0, b]:.5f} -> "
              f"{out['traj_losses'][-1, b]:.5f}")
    print(f"wrote {args.out}: setup {out['setup_f32_s']:.1f} s, trajectory "
          f"{out['traj_s']:.1f} s, newton f32 {out['newton_f32_s']:.1f} s, f64 "
          f"{out['newton_f64_s']:.1f} s")


if __name__ == "__main__":
    main()
