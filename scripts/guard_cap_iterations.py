"""LOBPCG iterations of the warm shape eigensolver's solves, with and
without `solvers.lobpcg.GUARD_SCALE_CAP` and with noise or host guard
columns, on the kinds of mesh sequence the shape, geometry and joint tasks
solve.

Each sequence marches an analytic SDF on the background grid at a few
nearby sizes: a host anchor on the first mesh, then warm solves on the
others, with the task's mode count (rigid block included) and its warm
solver's settings:

  * shape: a hollow ball (outer radius 0.42, the shell's thickness
    0.5 -> 0.44 of it), 32 + 6 modes, Steel (the thickness task's);
  * geometry: the ellipsoid (0.45, 0.32, 0.26) scaled 1.2 -> 1.14, 64 + 6
    modes, Ceramic (the geometry task's);
  * joint: the 0.35 ball scaled 1.0 -> 1.06, 8 + 6 modes, Ceramic, the
    joint task's 480 iterations a round.

For each of four variants, the cap off (the scale counts every guard's
Ritz value) or on, and the guard columns seeded with noise after an anchor
(the JAX package's warm solver) or solved for by the host, it prints each
warm solve's mode, LOBPCG iterations, largest residual, and largest
relative eigenvalue error over the elastic modes against host ARPACK, one
JSON line per sequence and variant.

    python -m scripts.guard_cap_iterations [--grid 16] [--device cpu|cuda]

On the card the solver works in float32 (its tolerance 3e-3), on the CPU
in float64 (1e-4) unless `--float32`."""

import argparse
import json
import time

import numpy as np
import torch

from diffsound_torch.fem.material import Material, MatSet, lame_params
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.grid import load_background_grid
from diffsound_torch.geometry.tasks import eigensolve_host
from diffsound_torch.geometry.warm_eigs import WarmShapeEigensolver
from diffsound_torch.solvers import lobpcg

SIGMA = 20000.0  # every task's host shift


def ball(points, r, inner=0.0):
    d = np.linalg.norm(points, axis=-1)
    return np.minimum(r - d, d - inner) if inner else r - d


def ellipsoid(points, axes):
    axes = np.asarray(axes, np.float64)
    return axes.min() * (1.0 - np.sqrt(((points / axes) ** 2).sum(-1)))


SEQUENCES = {
    "shape": dict(modes=32, mat=MatSet.Steel, max_iters=240, sdfs=[
        (lambda p, c=c: ball(p, 0.42, 0.42 * (1 - c))) for c in (0.5, 0.48, 0.46, 0.44)]),
    "geometry": dict(modes=64, mat=MatSet.Ceramic, max_iters=240, sdfs=[
        (lambda p, s=s: ellipsoid(p, s * np.array([0.45, 0.32, 0.26])))
        for s in (1.2, 1.18, 1.16, 1.14)]),
    "joint": dict(modes=8, mat=MatSet.Ceramic, max_iters=480, sdfs=[
        (lambda p, s=s: ball(p, 0.35 * s)) for s in (1.0, 1.02, 1.04, 1.06)]),
}


def run(name, seq, grid_verts, marching, device, dtype, cap, host_guards):
    lobpcg.GUARD_SCALE_CAP = cap
    mat = Material.of(seq["mat"])
    mu, lam = lame_params(mat.youngs / mat.density, mat.poisson)
    k = seq["modes"] + 6
    w = WarmShapeEigensolver(marching.num_grid_verts + marching.num_edges, k, dtype=dtype,
                             device=device, max_iters=seq["max_iters"])
    rows = []
    for sdf in seq["sdfs"]:
        out = marching(torch.as_tensor(grid_verts, device=device),
                       torch.as_tensor(sdf(grid_verts), device=device))
        comp = MarchingTets.compact(out)
        dof_rows = 3 * comp["num_verts"]

        def host_solve(n, out=out, comp=comp, dof_rows=dof_rows):
            vals, U = eigensolve_host(out, comp, mu, lam, n, SIGMA)
            if not host_guards:  # the guards as the JAX package seeds them
                rng = np.random.default_rng(1)
                U[:dof_rows, k:] = rng.standard_normal((dof_rows, n - k))
            return vals, U

        t0 = time.perf_counter()
        vals, _ = w.solve(out, comp, float(mu), float(lam), host_solve=host_solve)
        ms = 1e3 * (time.perf_counter() - t0)
        want = eigensolve_host(out, comp, mu, lam, k, SIGMA)[0]
        err = float(np.abs(np.asarray(vals)[6:] / want[6:] - 1).max())
        rows.append({"dof": dof_rows, "mode": w.last_mode, "iterations": w.last_iterations,
                     "resid": w.last_resid, "rel_err": err, "ms": ms})
    return {"sequence": name, "cap": cap, "guards": "host" if host_guards else "noise",
            "device": str(device), "dtype": str(dtype), "k": k, "solves": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--sequences", default=",".join(SEQUENCES))
    opts = ap.parse_args()
    device = torch.device(opts.device)
    dtype = torch.float32 if device.type == "cuda" or opts.float32 else torch.float64
    grid_verts, grid_tets = load_background_grid(opts.grid)
    grid_verts = grid_verts.astype(np.float64)
    marching = MarchingTets(grid_verts, grid_tets, device=device)
    cap0 = lobpcg.GUARD_SCALE_CAP
    for name in opts.sequences.split(","):
        for cap in (float("inf"), cap0):
            for host_guards in (False, True):
                print(json.dumps(run(name, SEQUENCES[name], grid_verts, marching, device, dtype,
                                     cap, host_guards)), flush=True)
    lobpcg.GUARD_SCALE_CAP = cap0


if __name__ == "__main__":
    main()
