"""The JAX package's float32 gap on the geometry phase of `chip_smoke.py`,
which holds the PyTorch port's float32 loss and gradient on the card to it
(that machine has no JAX).

At the phase's widths and recipe (`chip_smoke.GEOMETRY_SPEC`: grid 32,
freq_num 3, the 512-wide SDF MLP, 64 modes + 6, voxel 16, Ceramic): the
ellipsoid ground truth marched and compacted by the JAX package at grid 32
and written as .msh and surface OBJ, the CLI's voxel constraint from that
OBJ, the ground-truth eigenvalues (cold ARPACK), and a start pretrained
from PRNGKey(0) toward the ellipsoid scaled by `start` (2000 Adam steps at
lr 1e-4, float64).  At that start, on its compaction and host ARPACK basis,
one pass of `_loss_core` in float64 and one in float32 throughout (grid,
MLP, march, element operators: the JAX package's dtype on an accelerator);
it prints the float32 pass's gaps: the loss and the eigenvalue loss
(relative), the loss's gradient, the eigenvalue loss's gradient and its
deform part (relative norm), the numbers `chip_smoke.JAX_GEOMETRY` holds,
and the start mesh's smallest tet volume over its largest (the compaction
keeps tets down to 1e-9 of it).

Run on the CPU (about 10 minutes, most of it the pretraining):

    JAX_PLATFORMS=cpu python -m scripts.jax_geometry_reference

It prints one JSON line."""

import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from diffsound_tpu.fem.mesh import TetMesh, read_obj, write_obj  # noqa: E402
from diffsound_tpu.geometry.dmtet import MarchingTets  # noqa: E402
from diffsound_tpu.geometry.geometry_task import GeometryTask  # noqa: E402
from diffsound_tpu.geometry.grid import generate_background_grid  # noqa: E402
from diffsound_tpu.geometry.sdf_host import mesh_signed_distance  # noqa: E402

SPEC = chip_smoke.GEOMETRY_SPEC


def loss_pass(task, params, comp, U, target, q, sd, dtype):
    """(loss, eig_loss, grad, eig grad) of `_loss_core` in `dtype`; the
    gradients flattened over the MLP's Dense_0.. leaves then deform."""
    args = (jnp.asarray(comp["keep_idx"]), jnp.asarray(comp["tets"]),
            jnp.asarray(comp["tet_mask"], dtype), jnp.zeros(U.shape[1], dtype),
            jnp.asarray(U, dtype), jnp.asarray(target, dtype), jnp.asarray(q, dtype),
            jnp.asarray(sd, dtype), 0.0)
    (loss, (_, eig)), g = jax.jit(jax.value_and_grad(task._loss_core, has_aux=True))(
        params, *args)
    g_eig = jax.jit(jax.grad(lambda p, *a: task._loss_core(p, *a)[1][1]))(params, *args)

    def flat(tree):
        dense = tree["mlp"]["params"]
        leaves = [x for i in range(len(dense))
                  for x in (np.asarray(dense[f"Dense_{i}"]["kernel"]).T,
                            np.asarray(dense[f"Dense_{i}"]["bias"]))]
        return np.concatenate([np.ravel(x) for x in leaves + [np.asarray(tree["deform"])]]
                              ).astype(np.float64)

    return float(loss), float(eig), flat(g), flat(g_eig)


def main():
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp()
    gv, gtets = generate_background_grid(SPEC["grid"])
    gv = gv.astype(np.float64)
    mt = MarchingTets(gv, gtets)
    out = mt(jnp.asarray(gv), jnp.asarray(chip_smoke.ellipsoid_sdf(gv, SPEC["axes"])))
    comp = MarchingTets.compact(out)
    verts = np.asarray(out.all_verts)[comp["keep_idx"][: comp["num_verts"]]]
    TetMesh(verts, comp["tets"][: comp["num_tets"]]).export(os.path.join(tmp, "gt.msh"))
    write_obj(os.path.join(tmp, "gt_surf.obj"), *MarchingTets.compact_triangles(out))
    dof_gt = 3 * comp["num_verts"]

    sv, sf = read_obj(os.path.join(tmp, "gt_surf.obj"))
    lo, hi = sv.min(0), sv.max(0)
    center, size = (lo + hi) / 2, float((hi - lo).max()) * 1.05
    v = SPEC["voxel"]
    xs = np.linspace(-0.5, 0.5, v)
    Q = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3) * size
    sd = mesh_signed_distance(Q, sv - center, sf)

    task = GeometryTask(grid_res=SPEC["grid"], scale=size, freq_num=SPEC["freq_num"],
                        mode_num=SPEC["modes"], eig_method="host")
    gt = TetMesh.from_file(os.path.join(tmp, "gt.msh"))
    t0 = time.perf_counter()
    gt_vals = task.gt_eigenvalues_from_mesh(TetMesh(gt.vertices - center, gt.tets))
    gt_s = time.perf_counter() - t0
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          task.init_params(jax.random.PRNGKey(0)))
    t0 = time.perf_counter()
    start_sd = chip_smoke.ellipsoid_sdf(Q, SPEC["start"] * np.asarray(SPEC["axes"]))
    params = task.pretrain_sdf(params, Q, start_sd, iters=SPEC["pretrain"],
                               lr=SPEC["pretrain_lr"])
    pretrain_s = time.perf_counter() - t0
    out = task._march_params(params)
    comp = MarchingTets.compact(out)
    k = SPEC["modes"] + task.extra_modes
    t0 = time.perf_counter()
    _, U = task._eigensolve_host(out, comp, k)
    start_s = time.perf_counter() - t0

    p64 = loss_pass(task, params, comp, U, gt_vals, Q, sd, jnp.float64)
    task32 = GeometryTask(grid_res=SPEC["grid"], scale=size, freq_num=SPEC["freq_num"],
                          mode_num=SPEC["modes"], eig_method="host", dtype=jnp.float32)
    task32.geo.verts = task32.geo.verts.astype(jnp.float32)
    p32 = loss_pass(task32, jax.tree.map(lambda a: a.astype(jnp.float32), params), comp, U,
                    gt_vals, Q, sd, jnp.float32)
    n_def = gv.size
    vc = np.asarray(out.all_verts)[comp["keep_idx"]]
    tc = comp["tets"][: comp["num_tets"]]
    a, b, c, d = (vc[tc[:, i]] for i in range(4))
    vol = np.abs(np.einsum("ij,ij->i", a - d, np.cross(b - d, c - d))) / 6
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    print(json.dumps({
        "dof_gt": dof_gt, "dof_start": 3 * comp["num_verts"], "size": size,
        "gt_vals_head": [float(x) for x in gt_vals[:4]],
        "start_min_volume_ratio": float(vol.min() / vol.max()),
        "start_tets_below_1e-6": int((vol < 1e-6 * vol.max()).sum()),
        "loss_f64": p64[0], "eig_f64": p64[1],
        "f32_gap_loss": abs(p32[0] / p64[0] - 1), "f32_gap_eig": abs(p32[1] / p64[1] - 1),
        "f32_gap_grad": rel(p32[2], p64[2]), "f32_gap_eig_grad": rel(p32[3], p64[3]),
        "f32_gap_deform_grad": rel(p32[3][-n_def:], p64[3][-n_def:]),
        "gt_solve_s": gt_s, "pretrain_s": pretrain_s, "start_solve_s": start_s,
        "seconds": time.perf_counter() - t_start,
    }))


if __name__ == "__main__":
    main()
