"""How far float32 moves the shape tasks' Ritz pass, on the card and on the
CPU, over rotations of one basis.

`chip_smoke.py` holds the card's float32 Ritz values and dvals/dc at c 0.5
on the host ARPACK basis to a multiple of the JAX package's own float32 gap
(`SHAPE_F32_MARGIN`).  Each of those readings is one sample of float32's
rounding: the Ritz values and their derivative depend only on span(U), so
any rotation U Q (Q orthogonal, k x k) gives the same numbers in exact
arithmetic and another rounding in float32.  For each task at the shape
phase's widths this script builds the compact mesh at c 0.5 and its host
ARPACK basis once, then runs the port's `_coef_vals_jac` in float32 on the
card and on the CPU (a twin task on the same signed distances) at the basis
itself and at `--rotations` random rotations of it, and prints each gap to
the float64 pass on the CPU: the largest relative gap of the values and the
relative norm of the dvals/dc error, as `chip_smoke.shape_gate` measures
them.  For the unrotated float32 passes it also prints each mode's share of
the squared dvals/dc error beside the mode's relative gap to its nearest
neighbour in the spectrum.  Rotations leave the rounding of the mesh
itself alone; so on the first device (the card when there is one) the
float32 pass also runs with the mesh translated by `--shifts` random
offsets of up to a grid cell (stiffness and mass are exactly invariant
under a translation; the vertices' float32 rounding is not).

Run from the repository's root (a card is optional; without one only the
CPU rows are printed):

    python -m scripts.shape_f32_spread                      # both tasks, grid 64
    python -m scripts.shape_f32_spread --task morphing --grid 16 --rotations 2 --shifts 2

Prints one JSON line per task after its readable lines."""

import argparse
import json
import tempfile
import time

import numpy as np
import torch

import chip_smoke
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.tasks import MorphingTask, ThicknessTask


def twin_tasks(kind, meshes, grid, devices):
    """{device: task} on one set of signed distances (the first device's)."""
    spec = chip_smoke.THICKNESS_SPEC if kind == "thickness" else chip_smoke.MORPHING_SPEC
    cls = ThicknessTask if kind == "thickness" else MorphingTask
    tasks = {}
    for dev in devices:
        tasks[dev] = cls(grid_res=grid, scale=chip_smoke.SHAPE_SCALE, mat=chip_smoke.SHAPE_MAT,
                         mode_num=spec["modes"], device=dev)
    first = tasks[devices[0]]
    s = chip_smoke.SHAPE_SCALE
    if kind == "thickness":
        v, f = meshes["ball"]
        first.apply_sdf(v * s, f)
        for t in tasks.values():
            t.sdf, t.max_thickness = first.sdf.to(t.device), first.max_thickness
    else:
        (v1, f1), (v2, f2) = meshes["morph_ball"], meshes["morph_egg"]
        first.apply_sdf2(v1 * s, f1, v2 * s, f2)
        for t in tasks.values():
            t.sdf1, t.sdf2 = first.sdf1.to(t.device), first.sdf2.to(t.device)
    return tasks


def gaps(vals, dvals, ref_vals, ref_dvals):
    return (float(np.abs(vals / ref_vals - 1).max()),
            float(np.linalg.norm(dvals - ref_dvals) / np.linalg.norm(ref_dvals)))


def shifted_pass(task, c, comp, U, offset):
    """`_coef_vals_jac` with every marched vertex moved by `offset` (float64)
    before the working dtype's cast."""
    vertices = task.marching.vertices
    off = torch.as_tensor(offset, dtype=torch.float64, device=task.device)
    task.marching.vertices = lambda *a: vertices(*a) + off
    try:
        return task._coef_vals_jac(c, comp, U)
    finally:
        del task.marching.vertices


def run(kind, meshes, grid, rotations, shifts, devices):
    t_start = time.perf_counter()
    tasks = twin_tasks(kind, meshes, grid, devices)
    cpu = tasks["cpu"]
    c = 0.5
    comp = MarchingTets.compact(cpu._march_coef(c))
    for dev, t in tasks.items():
        other = MarchingTets.compact(t._march_coef(c))
        if not np.array_equal(other["keep_idx"], comp["keep_idx"]):
            raise RuntimeError(f"{kind}: the compact mesh on {dev} differs from the CPU's")
    t0 = time.perf_counter()
    _, U = cpu._eigensolve_host(cpu._march_coef(c), comp)
    arpack_s = time.perf_counter() - t0
    dof = 3 * comp["num_verts"]
    ref_vals, ref_dvals = cpu._coef_vals_jac(c, comp, U)  # float64 on the CPU
    res = {"task": kind, "grid": grid, "dof_c05": dof, "arpack_s": arpack_s}
    if grid == chip_smoke.SHAPE_GRID:
        want = chip_smoke.JAX_SHAPE[kind]
        res["f64_gap_to_jax"] = gaps(ref_vals, ref_dvals, np.asarray(want["vals_c05"]),
                                     np.asarray(want["dvals_c05"]))
        res["jax_f32_gap"] = (want["f32_gap_vals"], want["f32_gap_dvals"])
    vals = np.asarray(ref_vals)
    srt = np.sort(vals)
    near = np.array([np.min(np.abs(np.delete(srt, np.searchsorted(srt, v)) - v)) / v
                     for v in vals])
    rng = np.random.default_rng(0)
    qs = [np.eye(U.shape[1])] + [np.linalg.qr(rng.standard_normal((U.shape[1],) * 2))[0]
                                 for _ in range(rotations)]
    print(f"{kind}: grid {grid}, {dof} DOF at c {c}; host ARPACK {arpack_s:.3f} s; float64 "
          f"on the CPU against the JAX package's: {res.get('f64_gap_to_jax')}", flush=True)
    for dev, t in tasks.items():
        t.dtype = torch.float32
        rows = []
        for i, q in enumerate(qs):
            t0 = time.perf_counter()
            v32, d32 = t._coef_vals_jac(c, comp, U @ q)
            rows.append(gaps(v32, d32, ref_vals, ref_dvals) + (time.perf_counter() - t0,))
            if i == 0:
                share = (d32 - ref_dvals) ** 2 / np.sum((d32 - ref_dvals) ** 2)
                top = np.argsort(share)[::-1][:4]
                res[f"{dev}_top_modes"] = [(int(m), float(share[m]), float(near[m])) for m in top]
                res[f"{dev}_share_gap_below_1pct"] = float(share[near < 1e-2].sum())
        t.dtype = torch.float64
        d64 = gaps(*t._coef_vals_jac(c, comp, U), ref_vals, ref_dvals)
        res[dev] = {"basis": rows[0][:2], "rotations": [r[:2] for r in rows[1:]],
                    "f64_basis": d64, "pass_s": [r[2] for r in rows]}
        dv = [r[1] for r in rows]
        print(f"{kind} {dev}: float32 against float64, values / dvals/dc: basis "
              f"{rows[0][0]:.3e} / {rows[0][1]:.3e}; over {rotations} rotations values "
              f"{min(r[0] for r in rows[1:]):.3e}-{max(r[0] for r in rows[1:]):.3e}, dvals/dc "
              f"{min(dv[1:]):.3e}-{max(dv[1:]):.3e} (median {np.median(dv[1:]):.3e}); float64 "
              f"{d64[0]:.1e} / {d64[1]:.1e}; modes with the largest share of the dvals/dc "
              f"error (mode, share, relative gap to the nearest): "
              f"{[(m, round(s, 3), round(g, 5)) for m, s, g in res[dev + '_top_modes']]}; share "
              f"of modes within 1% of a neighbour {res[dev + '_share_gap_below_1pct']:.3f}",
              flush=True)
    t = tasks[devices[0]]
    cell = chip_smoke.SHAPE_SCALE / grid
    offsets = [rng.uniform(-cell, cell, 3) for _ in range(shifts)]
    t.dtype = torch.float64
    d64 = gaps(*shifted_pass(t, c, comp, U, offsets[0]), ref_vals, ref_dvals) if shifts else None
    t.dtype = torch.float32
    rows = [gaps(*shifted_pass(t, c, comp, U, o), ref_vals, ref_dvals) for o in offsets]
    t.dtype = torch.float64
    if rows:
        res[f"{devices[0]}_shifts"] = {"rows": rows, "f64_first": d64}
        dv = [r[1] for r in rows]
        print(f"{kind} {devices[0]}: float32 with the mesh translated, over {shifts} offsets "
              f"of up to {cell:.4f}: values {min(r[0] for r in rows):.3e}-"
              f"{max(r[0] for r in rows):.3e}, dvals/dc {min(dv):.3e}-{max(dv):.3e} (median "
              f"{np.median(dv):.3e}): {' '.join(f'{x:.3e}' for x in dv)}; float64 translated "
              f"{d64[0]:.1e} / {d64[1]:.1e}", flush=True)
    res["seconds"] = time.perf_counter() - t_start
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=("thickness", "morphing", "both"), default="both")
    ap.add_argument("--grid", type=int, default=chip_smoke.SHAPE_GRID)
    ap.add_argument("--rotations", type=int, default=8)
    ap.add_argument("--shifts", type=int, default=8)
    args = ap.parse_args()
    devices = (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]
    if devices[0] == "cuda":
        print(chip_smoke.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="shape_f32_spread_") as tmp:
        meshes = chip_smoke.shape_meshes(tmp)
    for kind in (("thickness", "morphing") if args.task == "both" else (args.task,)):
        print(json.dumps(run(kind, meshes, args.grid, args.rotations, args.shifts, devices)), flush=True)


if __name__ == "__main__":
    main()
