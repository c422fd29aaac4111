"""The JAX package's float64 numbers on the meshes of the shape phase of
`chip_smoke.py`, which holds the PyTorch port's float32 values on the card
to them (that machine has no JAX).

For each task, on the procedural OBJ meshes the shape phase writes (an
icosphere for thickness; an icosphere and an ellipsoid for morphing), at the
configs' widths (`dmtet_grid` 64, `mesh_scale` 1.5, Steel, order 1):

* the compact mesh's DOF at the target and at c = 0.5;
* the target eigenvalues (host ARPACK at the target coefficient);
* at c = 0.5, on the host ARPACK basis: the Ritz-refined eigenvalues, their
  derivative dvals/dc (`_coef_vals_jac`), the loss and dl/dc; and the same
  pass in float32 (the JAX package's dtype on its accelerator): its gap to
  float64 in the values (largest relative) and in dvals/dc (relative norm),
  the scale of float32's own error that the card's float32 is held to.

It also prints the JAX package's `CoefBins` logits from `PRNGKey(0)`, the
start of the thickness task's Adam loop.

Run on the CPU (the JAX package, not the port; a few minutes a task, most of
it host ARPACK):

    JAX_PLATFORMS=cpu python -m scripts.jax_shape_reference --task thickness
    JAX_PLATFORMS=cpu python -m scripts.jax_shape_reference --task morphing

Each prints one JSON line."""

import argparse
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from diffsound_tpu.fem.mesh import read_obj, write_obj
from diffsound_tpu.geometry.dmtet import MarchingTets
from diffsound_tpu.geometry.tasks import CoefBins, MorphingTask, ThicknessTask
from tests.test_geometry import icosphere

# the shape phase's meshes, in OBJ units (before mesh_scale); chip_smoke.py
# holds the same numbers
GRID, MESH_SCALE, MAT = 64, 1.5, "Steel"
THICKNESS = dict(radius=0.22, modes=32, target=0.4)
MORPHING = dict(radius=0.237, axes=(0.273, 0.182, 0.146), modes=16, target=0.7)


def obj_meshes(task: str, tmp: str):
    """The phase's meshes after the OBJ round trip (9 significant digits)."""
    if task == "thickness":
        shapes = {"ball": icosphere(2, THICKNESS["radius"])}
    else:
        v, f = icosphere(2, MORPHING["radius"])
        shapes = {"ball": (v, f), "egg": (v / MORPHING["radius"] * np.array(MORPHING["axes"]), f)}
    out = []
    for name, (v, f) in shapes.items():
        path = os.path.join(tmp, f"{name}.obj")
        write_obj(path, v, f)
        out.append(read_obj(path))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=("thickness", "morphing"), required=True)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    t_start = time.perf_counter()
    spec = THICKNESS if args.task == "thickness" else MORPHING
    with tempfile.TemporaryDirectory() as tmp:
        meshes = obj_meshes(args.task, tmp)
    kw = dict(grid_res=GRID, scale=MESH_SCALE, mat=MAT, mode_num=spec["modes"])
    if args.task == "thickness":
        task = ThicknessTask(**kw)
        task.apply_sdf(meshes[0][0] * MESH_SCALE, meshes[0][1])
    else:
        task = MorphingTask(**kw)
        (v1, f1), (v2, f2) = meshes
        task.apply_sdf2(v1 * MESH_SCALE, f1, v2 * MESH_SCALE, f2)
    t_sdf = time.perf_counter() - t_start

    c_t = spec["target"]
    t0 = time.perf_counter()
    target = task.eigenvalues(c_t)
    t_target = time.perf_counter() - t0
    dof_target = 3 * MarchingTets.compact(task._march_coef(jnp.asarray(c_t)))["num_verts"]

    c = 0.5
    out = task._march_coef(jnp.asarray(c))
    comp = MarchingTets.compact(out)
    t0 = time.perf_counter()
    _, U = task._eigensolve_host(out, comp)
    t_basis = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, dvals = task._coef_vals_jac(c, comp, U)
    t_jac = time.perf_counter() - t0
    r = (vals - target) / target
    task.dtype, task._loss_cache = jnp.float32, {}
    vals32, dvals32 = task._coef_vals_jac(c, comp, U)
    r32 = (vals32 - target) / target
    res = {
        "task": args.task, "grid": GRID, "mesh_scale": MESH_SCALE, **spec,
        "dof_target": int(dof_target), "dof_c05": 3 * comp["num_verts"],
        "num_tets_c05": comp["num_tets"],
        "max_sdf": float(task.max_thickness) if args.task == "thickness" else None,
        "target_vals": [float(x) for x in target],
        "vals_c05": [float(x) for x in vals],
        "dvals_c05": [float(x) for x in dvals],
        "loss_c05": float(np.mean(r**2)),
        "dldc_c05": float(2.0 * np.mean(r * dvals / target)),
        "f32_gap_vals": float(np.abs(vals32 / vals - 1).max()),
        "f32_gap_dvals": float(np.linalg.norm(dvals32 - dvals) / np.linalg.norm(dvals)),
        "dldc_c05_f32": float(2.0 * np.mean(r32 * dvals32 / target)),
        "coef_logits_prngkey0": [float(x) for x in
                                 np.asarray(CoefBins(32).init_params(jax.random.PRNGKey(0))["coef_logits"])],
        "seconds": {"sdf_and_setup": t_sdf, "target_arpack": t_target,
                    "basis_arpack": t_basis, "vals_jac": t_jac,
                    "total": time.perf_counter() - t_start},
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
