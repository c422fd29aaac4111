"""Geometric shape estimation: a neural-SDF geometry optimised against modal
eigenvalues under a coarse voxel constraint.

Counterpart of `diffsound_tpu/geometry/geometry_task.py::GeometryTask`: an
SDF MLP (+ a bounded per-vertex deform) defines the shape through solid
marching tets; stage 1 pretrains the MLP to satisfy the voxel sign
constraint (full-batch Adam, 2000 iterations at lr 1e-4); stage 2 minimises

    mesh_template_loss + 2e-4 * sqrt(mean((vals - gt)^2 / gt^2))

with Adam and a staircase decay of 0.8 every 100 steps, an eigensolve every
iteration, keeping the best-loss mesh.

Per iteration: the march runs detached in float64 on the device and is
compacted on the host; the eigenpairs come from the warm device solver
(host ARPACK for cold starts and every REANCHOR_EVERY warm solves); the
loss and its gradient in every MLP parameter and in `deform` come from one
reverse-mode pass in the working dtype (float64 on the CPU, float32 on the
card) through the template hinge, the kept rows of the march
(`MarchingTets.vertices`), the element operators and the Ritz-refined
eigenvalues.  The parts are timed with CUDA events and one sync at the end
of the step.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import scipy.sparse.linalg as spla
import torch

from .. import default_dtype, resolve_device
from ..fem import assembly
from ..fem.material import Material, MatSet, lame_params
from ..solvers.diff_eigs import ritz_refined_eigenvalues
from .dmtet import MarchingTets
from .grid import load_background_grid
from .sdf_mlp import SDFGeometry, cast_params
from .tasks import eigensolve_host
from .warm_eigs import WarmShapeEigensolver, padded_gather_transpose

# the failures of an eigensolve on a degenerate mesh that `optimize` skips
SOLVER_FAILURES = (spla.ArpackNoConvergence, spla.ArpackError, torch.linalg.LinAlgError)


def _detach(params):
    return {"mlp": {k: v.detach() for k, v in params["mlp"].items()},
            "deform": params["deform"].detach()}


def _leaves(params):
    """(a copy of params whose tensors are fresh leaves requiring grad, the
    list of those leaves: the MLP's in order, then deform)."""
    mlp = {k: v.detach().clone().requires_grad_(True) for k, v in params["mlp"].items()}
    deform = params["deform"].detach().clone().requires_grad_(True)
    return {"mlp": mlp, "deform": deform}, [*mlp.values(), deform]


class _Clock:
    """Marks between the parts of a step: CUDA events on the card, read
    after the step's one sync; perf_counter on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """Seconds between consecutive marks (syncs on the last event)."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


class GeometryTask:
    # a host re-anchor after this many warm solves in a row: the SDF
    # geometry moves faster per iteration than the scalar shape tasks'
    REANCHOR_EVERY = 50

    def __init__(
        self,
        grid_res: int = 32,
        scale: float = 1.0,
        freq_num: int = 1,
        mode_num: int = 64,
        mat=MatSet.Ceramic,
        tets_dir: Optional[str] = None,
        eig_method: str = "warm",
        refresh_every: int = 1,
        device="cuda",
    ):
        """eig_method: "warm" (the device solver, host ARPACK for cold
        starts and every REANCHOR_EVERY warm solves) or anything else for
        host ARPACK at every solve.
        refresh_every: the true eigensolve's cadence; the steps between map
        the stored basis across the remesh (`WarmShapeEigensolver.map_only`).
        One Adam step on the MLP moves the eigenvalues by a median 2.5%, so
        use more than 1 only with steps whose eigenvalue drift is well under
        1%."""
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device)
        kw = {} if tets_dir is None else {"tets_dir": tets_dir}
        verts, tets = load_background_grid(grid_res, **kw)
        self.grid_verts = verts.astype(np.float64) * scale
        self.marching = MarchingTets(self.grid_verts, tets, device=self.device)
        self.geo = SDFGeometry(self.grid_verts, grid_res, scale, freq_num, device=self.device)
        self.mat = Material.of(mat)
        self.mode_num = mode_num
        self.sigma = 20000.0  # the shift of the host solve
        self.extra_modes = 6  # the rigid block
        if eig_method == "warm":
            self.warm = WarmShapeEigensolver(
                self.marching.num_grid_verts + self.marching.num_edges,
                mode_num + self.extra_modes, dtype=self.dtype, device=self.device,
                reanchor_every=self.REANCHOR_EVERY,
            )
        else:
            self.warm = None
        self.refresh_every = refresh_every
        self._steps_since_refresh = 0

    def _lame(self):
        return lame_params(self.mat.youngs / self.mat.density, self.mat.poisson)

    def init_params(self, generator: torch.Generator):
        return self.geo.init_params(generator)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # -- stage 1: voxel-constraint pretraining ------------------------------

    def pretrain_sdf(self, params, query_points, signed_distance, iters: int = 2000,
                     lr: float = 1e-4, margin: float = 0.0, verbose: bool = False):
        """Full-batch Adam on the template hinge; stops after the first step
        whose loss (before its update) is exactly 0."""
        q, sd = self._tensor(query_points), self._tensor(signed_distance)
        p, leaves = _leaves(params)
        opt = torch.optim.Adam(leaves, lr=lr)
        for i in range(iters):
            opt.zero_grad(set_to_none=True)
            loss = self.geo.mesh_template_loss(p, q, sd, margin)
            loss.backward()
            opt.step()
            loss = loss.item()
            if verbose and i % 500 == 0:
                print(f"  sdf pretrain {i}: {loss:.6f}")
            if loss == 0.0:
                break
        return _detach(p)

    # -- marching + eigensolve ---------------------------------------------

    def _march_params(self, params):
        return self.marching(self.geo.deformed_verts(params), self.geo.sdf(params))

    def _eigensolve_host(self, out, comp, k):
        return eigensolve_host(out, comp, *self._lame(), k, self.sigma)

    def gt_eigenvalues_from_mesh(self, mesh) -> np.ndarray:
        """Ground-truth corrected eigenvalues (mode_num) of a reference tet
        mesh: a cold host ARPACK solve at `sigma` in float64."""
        from ..models.sound_obj import DiffSoundObject

        obj = DiffSoundObject(mesh=mesh, mode_num=self.mode_num, order=1, mat=self.mat,
                              task="gt", dtype=torch.float64, device="cpu")
        eig = obj.eigen_decomposition(sigma=self.sigma)
        with torch.no_grad():
            return obj.get_vals({}, eig).numpy()

    # -- stage 2: eigenvalue-driven shape optimisation -----------------------

    def _loss_core(self, params, comp, U, target, q, sd, margin):
        """(loss, (template, eig_loss)) at params on the compaction `comp`
        and the detached basis U (3 * Vc_pad, k), in the params' dtype."""
        template = self.geo.mesh_template_loss(params, q, sd, margin)
        verts_c = self.marching.vertices(self.geo.deformed_verts(params), self.geo.sdf(params),
                                         None, comp["keep_idx"])
        dt, dev = verts_c.dtype, verts_c.device
        ops = assembly.build_element_ops(
            verts_c, comp["tets"], 1, dtype=dt,
            tet_mask=torch.as_tensor(comp["tet_mask"], dtype=dt, device=dev),
            gather_idx=padded_gather_transpose(comp),
        )
        mu, lame_l = self._lame()
        U = torch.as_tensor(U, dtype=dt, device=dev)
        vals = ritz_refined_eigenvalues(
            lambda x: assembly.k_matvec(ops, x, mu, lame_l),
            lambda x: assembly.m_matvec(ops, x, 1.0),
            U,
        )[self.extra_modes:]
        target = torch.as_tensor(np.asarray(target), dtype=dt, device=dev)
        eig_loss = torch.sqrt(torch.mean((vals - target) ** 2 / target**2))
        return template + 2e-4 * eig_loss, (template, eig_loss)

    def loss_grad(self, params, comp, U, target, q, sd, margin=0.0):
        """(loss, (template, eig_loss), grads as a params-shaped dict): one
        reverse-mode pass of `_loss_core`."""
        p, leaves = _leaves(params)
        loss, aux = self._loss_core(p, comp, U, target, q, sd, margin)
        g = torch.autograd.grad(loss, leaves)
        names = list(p["mlp"])
        return loss.detach(), tuple(a.detach() for a in aux), {
            "mlp": dict(zip(names, g[:-1])), "deform": g[-1]}

    def step_loss_grad(self, params, target, q, sd, margin=0.0):
        """One iteration: the detached float64 march and its compaction, the
        eigensolve, the loss and its gradient.  Returns (loss, (template,
        eig_loss), grads, comp, out, timing)."""
        clock = _Clock(self.device)
        clock.mark()
        with torch.no_grad():
            out = self._march_params(cast_params(params, torch.float64))
        clock.mark()
        comp = MarchingTets.compact(out)
        clock.mark()
        k = len(target) + self.extra_modes
        host_path = self.warm is None or k != self.warm.k
        if host_path:
            # also the experiment's mode-count sweep, where k differs from
            # the warm solver's fixed basis width
            lam, U = self._eigensolve_host(out, comp, k)
        else:
            mapped = None
            if self.refresh_every > 1 and self._steps_since_refresh + 1 < self.refresh_every:
                mapped = self.warm.map_only(out, comp)
            if mapped is not None:
                self._steps_since_refresh += 1
                lam, U = mapped
            else:
                self._steps_since_refresh = 0
                mu, lame_l = self._lame()
                lam, U = self.warm.solve(
                    out, comp, float(mu), float(lame_l),
                    host_solve=lambda: self._eigensolve_host(out, comp, k),
                )
        clock.mark()
        loss, aux, g = self.loss_grad(params, comp, U, target, q, sd, margin)
        clock.mark()
        march_s, compact_s, solve_s, loss_grad_s = clock.seconds()
        timing = {"march_s": march_s, "compact_s": compact_s, "solve_s": solve_s,
                  "loss_grad_s": loss_grad_s}
        if host_path:
            timing["solve_mode"], timing["solve_iters"] = "host", 0
        else:
            timing["solve_mode"] = self.warm.last_mode
            timing["solve_iters"] = self.warm.last_iterations
        return loss, aux, g, comp, out, timing

    def optimize(self, params, target, query_points, signed_distance, iters: int = 1000,
                 lr: float = 1e-5, margin: float = 0.0, verbose: bool = True, on_iter=None,
                 time_budget_s=None, on_best=None):
        """Adam with lr * 0.8^(step // 100) over every parameter.

        on_iter(rec): called each iteration with its metric record.
        time_budget_s: a wall-clock deadline; the loop stops cleanly past it,
        so the caller still gets the best mesh and the history.
        on_best(best): called whenever the best mesh improves (host arrays
        best["verts"], best["tets"]).

        An iteration whose eigensolve fails (SOLVER_FAILURES) is printed,
        recorded in the history as {"iter": it, "skipped": reason} and takes
        no step.  Returns (params, best, history)."""
        t_start = time.perf_counter()
        q, sd = self._tensor(query_points), self._tensor(signed_distance)
        tgt = np.asarray(target, np.float64)
        p, leaves = _leaves(params)
        opt = torch.optim.Adam(leaves, lr=lr)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=100, gamma=0.8)
        best = {"loss": math.inf, "mesh": None}
        history = []
        for it in range(iters):
            try:
                loss, (tmpl, eig_l), g, comp, out, timing = self.step_loss_grad(
                    p, tgt, q, sd, margin)
            except SOLVER_FAILURES as e:
                reason = f"{type(e).__name__}: {e}"
                print(f"iter {it}: eigensolve failed ({reason}); skipping step", flush=True)
                history.append({"iter": it, "skipped": reason})
                continue
            for leaf, gl in zip(leaves, [*g["mlp"].values(), g["deform"]]):
                leaf.grad = gl
            opt.step()
            sched.step()
            rec = {"iter": it, "loss": loss.item(), "template": tmpl.item(), "eig": eig_l.item()}
            rec.update(timing)
            history.append(rec)
            if on_iter is not None:
                on_iter(rec)
            if rec["loss"] < best["loss"]:
                with torch.no_grad():
                    rows = torch.as_tensor(comp["keep_idx"][: comp["num_verts"]],
                                           device=out.all_verts.device)
                    vc = out.all_verts[rows].cpu().numpy()
                best = {"loss": rec["loss"], "verts": vc, "tets": comp["tets"][: comp["num_tets"]],
                        "eig_loss": rec["eig"]}
                if on_best is not None:
                    on_best(best)
            if verbose and it % 10 == 0:
                print(f"iter {it}: loss {rec['loss']:.6f} (template {rec['template']:.6f}, "
                      f"eig {rec['eig']:.6f}) [{timing['solve_mode']}/{timing['solve_iters']} "
                      f"march {timing['march_s']:.2f}s compact {timing['compact_s']:.2f}s "
                      f"solve {timing['solve_s']:.2f}s grad {timing['loss_grad_s']:.2f}s]",
                      flush=True)
            if time_budget_s is not None and time.perf_counter() - t_start > time_budget_s:
                print(f"iter {it}: time budget {time_budget_s:.0f}s reached after "
                      f"{it + 1}/{iters} iters; stopping", flush=True)
                break
        return _detach(p), best, history
