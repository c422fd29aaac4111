"""Thickness inference experiment CLI: march hollow-mesh targets and recover
their thickness coefficients from modal eigenvalues.

Counterpart of `diffsound_tpu/experiments/thickness.py` (the reference's
thickness_generate.py + thickness_train.py): for each target thickness in
thickness_list, the target eigenvalues of the hollow mesh marched at that
coefficient, then the coefficient recovered by Adam over the 32 bins
(`"optimizer": "adam"`, `iter` steps) or by scalar Gauss-Newton
(`"optimizer": "newton"`, at most 40 iterations); per-target lines and the
total squared error go to `result_<mesh_name>.txt`, the recovered surface
to `<mesh_name>/result<thickness>.obj`.

Run: python -m diffsound_torch.experiments.thickness --config configs/thickness_train.json
(add "device": "cpu" to the JSON, or --device cpu, to run on the CPU; the
default is CUDA).
"""

from __future__ import annotations

import os
import time

from ..fem.mesh import read_obj, write_obj
from ..geometry.dmtet import MarchingTets
from ..geometry.tasks import ThicknessTask
from ..utils.logging import MetricLogger


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags(
        "thickness (diffsound-torch)",
        defaults={"mode_num": 32, "order": 1, "mat": "Steel", "optimizer": "adam",
                  "device": "cuda"},
        argv=argv,
    )
    os.makedirs(flags.out_dir, exist_ok=True)
    logger = MetricLogger(flags.out_dir)

    mverts, mfaces = read_obj(os.path.join(flags.init_mesh_dir, flags.mesh_name + ".obj"))

    results = []
    total_error = 0.0
    result_path = os.path.join(flags.out_dir, f"result_{flags.mesh_name}.txt")
    with open(result_path, "a") as f:
        f.write(f"material:{flags.mat}\n")

    for thickness in flags.thickness_list:
        # target eigenvalues of the hollow mesh marched at the target
        # coefficient
        task = ThicknessTask(
            grid_res=flags.dmtet_grid, scale=flags.mesh_scale, mat=flags.mat,
            mode_num=flags.mode_num, eig_method=getattr(flags, "eig_method", "warm"),
            device=flags.device,
        )
        task.apply_sdf(mverts * flags.mesh_scale, mfaces)
        target = task.eigenvalues(thickness)
        print(f"target thickness {thickness}: gt vals[:4] = {target[:4]}")

        log = lambda it, loss, coef: logger.scalars({"loss": loss, "thickness": coef}, it)
        t0 = time.perf_counter()
        if flags.optimizer == "newton":
            result, history = task.newton_optimize(target, iters=min(flags.iter, 40),
                                                   callback=log)
        else:
            _, history = task.optimize(target, iters=flags.iter, lr=flags.learning_rate,
                                       callback=log)
            result = history[-1]["coef"]
        wall = time.perf_counter() - t0
        total_error += (result - thickness) ** 2 / len(flags.thickness_list)
        results.append((thickness, result))
        its = len(history) / wall
        warm = task.warm.total_warm if task.warm else 0
        cold = task.warm.total_cold if task.warm else 0
        print(f"target:{thickness} result:{result} "
              f"({its:.2f} it/s, {warm} warm / {cold} cold solves)")
        with open(result_path, "a") as f:
            f.write(f"target:{thickness} result:{result} "
                    f"iters_per_sec:{its:.3f} warm:{warm} cold:{cold}\n")

        # export the recovered surface
        out = task._march(task.sdf, result * task.max_thickness)
        sv, st = MarchingTets.compact_triangles(out)
        os.makedirs(os.path.join(flags.out_dir, flags.mesh_name), exist_ok=True)
        write_obj(os.path.join(flags.out_dir, flags.mesh_name, f"result{thickness}.obj"), sv, st)

    print(f"total error:{total_error}")
    with open(result_path, "a") as f:
        f.write(f"total error:{total_error}\n")
    logger.close()
    return results


if __name__ == "__main__":
    main()
