"""Geometric shape estimation experiment CLI.

Counterpart of `diffsound_tpu/experiments/geometry.py`: for each shape in
mesh_name_list and each voxel resolution, the ground-truth eigenvalues of
the reference tet mesh `<init_mesh_dir>/<name>.msh`, the voxelised surface
`<name>_surf.obj` as a coarse constraint, the SDF MLP pretrained on it
(2000 iterations), then the eigenvalue-driven optimisation keeping the best
mesh.  Writes `<out_dir>/<voxel>/<name>_voxel.obj`, the best mesh
`<name>_<modes>.msh` (whenever the best improves, at most every 120 s with
the first improvement written at once, and at the end, a time-budget stop
included) and the metric log `metrics.jsonl`.

Run: python -m diffsound_torch.experiments.geometry --config configs/geometry_train.json
(add "device": "cpu" to the JSON, or --device cpu, to run on the CPU; the
default is CUDA).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..fem.mesh import TetMesh, read_obj, write_obj
from ..geometry.geometry_task import GeometryTask
from ..geometry.sdf_host import mesh_signed_distance
from ..geometry.sdf_mlp import voxel_boundary_faces
from ..utils.logging import MetricLogger

EXPORT_EVERY_S = 120.0


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags("geometry (diffsound-torch)", defaults={"device": "cuda"}, argv=argv)
    os.makedirs(flags.out_dir, exist_ok=True)
    results = []
    for voxel_num in flags.voxel_num_list:
        out_dir = os.path.join(flags.out_dir, str(voxel_num))
        os.makedirs(out_dir, exist_ok=True)
        logger = MetricLogger(out_dir)
        for model_name in flags.mesh_name_list:
            # ground-truth eigenvalues from the reference tet mesh
            gt_mesh = TetMesh.from_file(os.path.join(flags.init_mesh_dir, model_name + ".msh"))
            # surface mesh -> centred voxel constraint
            sverts, sfaces = read_obj(
                os.path.join(flags.init_mesh_dir, model_name + "_surf.obj"))
            lo, hi = sverts.min(0), sverts.max(0)
            center = (lo + hi) / 2
            size = float((hi - lo).max()) * 1.05
            sverts = sverts - center

            xs = np.linspace(-0.5, 0.5, voxel_num)
            Q = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
            sd = mesh_signed_distance(Q * size, sverts, sfaces, flags.device).cpu().numpy()
            occ_coords = np.argwhere(sd.reshape(voxel_num, voxel_num, voxel_num) > 0)
            vverts, vtris = voxel_boundary_faces(occ_coords, voxel_num)
            write_obj(os.path.join(out_dir, f"{model_name}_voxel.obj"),
                      vverts / voxel_num * size - size / 2, vtris)

            for mode_num in flags.mode_num_list:
                task = GeometryTask(
                    grid_res=flags.grid_res, scale=size, freq_num=flags.freq_num,
                    mode_num=mode_num, refresh_every=int(getattr(flags, "refresh_every", 1)),
                    device=flags.device,
                )
                gt_vals = task.gt_eigenvalues_from_mesh(
                    TetMesh(gt_mesh.vertices - center, gt_mesh.tets))
                params = task.init_params(torch.Generator().manual_seed(0))
                print(f"{model_name}/{voxel_num}/{mode_num}: pretraining SDF")
                params = task.pretrain_sdf(params, Q * size, sd, iters=2000, lr=1e-4,
                                           verbose=True)
                print("optimizing against eigenvalues")
                tag = f"{model_name}_{mode_num}"

                def stream(rec, tag=tag):
                    # the eig loss under the reference's tag, then every
                    # numeric field of the record (the parts' seconds,
                    # solve_iters)
                    logger.scalar(tag, rec["eig"], rec["iter"])
                    logger.scalars({f"{tag}/{k}": v for k, v in rec.items()
                                    if k not in ("iter", "eig") and isinstance(v, (int, float))},
                                   rec["iter"])

                export_path = os.path.join(out_dir, f"{tag}.msh")
                last_export = [-math.inf]  # the first improvement is written at once

                def export_best(best, path=export_path, last=last_export):
                    # throttled checkpoint of the running best, so a killed
                    # run keeps its mesh
                    now = time.monotonic()
                    if now - last[0] < EXPORT_EVERY_S:
                        return
                    last[0] = now
                    TetMesh(best["verts"], best["tets"]).export(path + ".part")
                    os.replace(path + ".part", path)

                params, best, hist = task.optimize(
                    params, gt_vals, Q * size, sd, iters=flags.iter, lr=flags.learning_rate,
                    time_budget_s=getattr(flags, "time_budget_s", None),
                    on_iter=stream, on_best=export_best,
                )
                # the final best, also after a time-budget stop
                if best.get("verts") is not None:
                    TetMesh(best["verts"], best["tets"]).export(export_path)
                print(f"best eig loss: {best.get('eig_loss')}")
                results.append((model_name, voxel_num, mode_num, best.get("eig_loss"), hist))
        logger.close()
    return results


if __name__ == "__main__":
    main()
