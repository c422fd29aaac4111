"""Morphing-coefficient inference experiment CLI.

Counterpart of `diffsound_tpu/experiments/morphing.py` (the reference's
morphing_generate.py + morphing_train.py): for each target coefficient in
morphing_list, the target eigenvalues of the blended shape
sdf = c sdf1 + (1 - c) sdf2, then c recovered from 0.5 by Adam over the 32
bins (`"optimizer": "adam"`, `iter` steps, the bins pretrained to 0.5) or
by scalar Gauss-Newton (`"optimizer": "newton"`, at least 25 iterations);
per-target lines and the total squared error go to
`result_<mesh_name1>_<mesh_name2>.txt`.

Run: python -m diffsound_torch.experiments.morphing --config configs/morphing_train.json
(add "device": "cpu" to the JSON, or --device cpu, to run on the CPU; the
default is CUDA).
"""

from __future__ import annotations

import os
import time

from ..fem.mesh import read_obj
from ..geometry.tasks import MorphingTask
from ..utils.logging import MetricLogger


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags(
        "morphing (diffsound-torch)",
        defaults={"mode_num": 16, "order": 1, "mat": "Steel", "optimizer": "adam",
                  "device": "cuda"},
        argv=argv,
    )
    os.makedirs(flags.out_dir, exist_ok=True)
    logger = MetricLogger(flags.out_dir)

    v1, f1 = read_obj(os.path.join(flags.init_mesh_dir, flags.mesh_name1 + ".obj"))
    v2, f2 = read_obj(os.path.join(flags.init_mesh_dir, flags.mesh_name2 + ".obj"))

    result_path = os.path.join(flags.out_dir, f"result_{flags.mesh_name1}_{flags.mesh_name2}.txt")
    results = []
    total_error = 0.0
    for coef in flags.morphing_list:
        task = MorphingTask(
            grid_res=flags.dmtet_grid, scale=flags.mesh_scale, mat=flags.mat,
            mode_num=flags.mode_num, eig_method=getattr(flags, "eig_method", "warm"),
            device=flags.device,
        )
        task.apply_sdf2(v1 * flags.mesh_scale, f1, v2 * flags.mesh_scale, f2)
        target = task.eigenvalues(coef)
        print(f"target coef {coef}: gt vals[:4] = {target[:4]}")
        t0 = time.perf_counter()
        if flags.optimizer == "newton":
            result, history = task.newton_optimize(target, iters=max(flags.iter, 25), c0=0.5)
        else:
            _, history = task.optimize(target, iters=flags.iter, lr=flags.learning_rate,
                                       init_coef=0.5)
            result = history[-1]["coef"]
        for h in history:
            logger.scalars({"loss": h["loss"], "coef": h["coef"]}, h["iter"])
        wall = time.perf_counter() - t0
        total_error += (result - coef) ** 2 / len(flags.morphing_list)
        results.append((coef, result))
        its = len(history) / wall
        print(f"target:{coef} result:{result} ({its:.2f} it/s)")
        with open(result_path, "a") as f:
            f.write(f"target:{coef} result:{result} iters_per_sec:{its:.3f}\n")
    with open(result_path, "a") as f:
        f.write(f"total error:{total_error}\n")
    print(f"total error:{total_error}")
    logger.close()
    return results


if __name__ == "__main__":
    main()
