"""The JAX package's modal-Newton fit on the cube the port's chip_smoke.py
uses, for one flagship material pair: `MaterialSyncTask.train_newton` with
no polish, on `cube_tet_mesh(n, 0.3)` at order 2, 16 modes, 8000 samples at
32 kHz, the package's default three extraction windows and 20 rounds.  It
is the reference for the port's fit where the fit misses the target.

Run on the CPU (the JAX package, not the port):

    JAX_PLATFORMS=cpu python -m scripts.jax_newton_reference --n 9 --pair 0 --dtype float32

It prints the fit's rounds as it goes, then one JSON line with the mesh's
DOF, the chosen E and nu, the target's, and the wall seconds."""

import argparse
import json
import time

import jax
import jax.numpy as jnp

from diffsound_tpu.experiments.material_sync import MaterialSyncTask, random_material_pairs
from diffsound_tpu.fem.mesh import cube_tet_mesh


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=9, help="cube_tet_mesh cells per edge")
    ap.add_argument("--pair", type=int, default=0, help="flagship pair index")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    init_mat, gt_mat = random_material_pairs(jax.random.PRNGKey(0), args.pair + 1)[args.pair]
    task = MaterialSyncTask(mesh=cube_tet_mesh(args.n, 0.3), mode_num=16, sample_rate=32000.0,
                            frame_num=8000, force_frame_num=150, exp_mode=3,
                            dtype=getattr(jnp, args.dtype))
    gt_audio, _ = task.make_gt(gt_mat)
    t0 = time.perf_counter()
    res = task.train_newton(init_mat, gt_audio, rounds=args.rounds, polish_epochs=0,
                            verbose=True)
    wall = time.perf_counter() - t0
    dof = 3 * (2 * args.n + 1) ** 3
    print(json.dumps({"n": args.n, "dof": dof, "pair": args.pair, "dtype": args.dtype,
                      "E": res["youngs"], "nu": res["poisson"], "target_E": gt_mat[1],
                      "target_nu": gt_mat[2], "fit_s": wall}))


if __name__ == "__main__":
    main()
