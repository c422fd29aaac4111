"""Shape inference tasks over marching tets: thickness and morphing.

Counterpart of `diffsound_tpu/geometry/tasks.py` (`ShapeTaskBase`,
`CoefBins`, `ThicknessTask`, `MorphingTask`):

  * thickness: infer a shell-thickness coefficient (a weighted value over
    32 linear bins, scaled by max(sdf)) so that the hollow mesh's modal
    eigenvalues match a target;
  * morphing: infer the coefficient c of sdf = c sdf1 + (1 - c) sdf2.

Per iteration the current geometry is marched on the device and compacted
on the host into bucket-padded shapes; the eigenpairs come from the warm
device solver (`warm_eigs.py`; host ARPACK for cold starts); and the
Ritz-refined eigenvalues and their derivative with respect to the scalar
coefficient come from one forward-mode pass through the marching-tets
vertex interpolation and the element operators.  The coefficient is a
scalar, so forward mode gives all of dvals/dc at about the cost of one
evaluation and stores no residuals (the JAX package's reverse mode needed
one cotangent per mode, chunked to fit).

The march and the signed distances run in float64 on every device (their
comparisons decide the mesh); the differentiable pass runs in
`default_dtype(device)`: float64 on the CPU, float32 on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import default_dtype, resolve_device
from ..audio.oscillator import uniform, weighted_value
from ..fem import assembly
from ..fem.material import Material, lame_params
from ..solvers.arpack import eigsh_shift_invert
from ..solvers.diff_eigs import ritz_refined_eigenvalues
from .dmtet import MarchingTets
from .grid import load_background_grid
from .sdf_host import mesh_signed_distance
from .warm_eigs import WarmShapeEigensolver, padded_gather_transpose


def eigensolve_host(out, comp, mu: float, lam: float, k: int, sigma: float):
    """ARPACK (k modes near sigma) on the compacted geometry of a march, in
    float64 on the host; returns padded (lam (k,), U (3 * Vc_pad, k)) as
    numpy, zero on the pad rows."""
    with torch.no_grad():
        keep = torch.as_tensor(comp["keep_idx"], device=out.all_verts.device)
        verts_c = out.all_verts[keep].to(device="cpu", dtype=torch.float64)
    ops = assembly.build_element_ops(
        verts_c, comp["tets"], 1, dtype=torch.float64,
        tet_mask=torch.as_tensor(comp["tet_mask"], dtype=torch.float64),
        gather_idx=padded_gather_transpose(comp),
    )
    K, M = assembly.assemble_scipy(ops, mu, lam, 1.0)
    n_real = 3 * comp["num_verts"]
    vals, vecs = eigsh_shift_invert(K[:n_real, :n_real], M[:n_real, :n_real], k=k, sigma=sigma)
    U = np.zeros((3 * len(comp["keep_idx"]), k))
    U[:n_real] = vecs
    return vals, U


class ShapeTaskBase:
    """Shared marching/compaction/eigensolve machinery."""

    def __init__(
        self,
        grid_res: int,
        scale: float,
        mat,
        mode_num: int = 32,
        order: int = 1,
        tets_dir: Optional[str] = None,
        eig_method: str = "warm",
        device="cuda",
    ):
        """eig_method: "warm" (the device solver, host ARPACK for cold
        starts) or anything else for host ARPACK at every solve."""
        if order != 1:
            raise NotImplementedError("shape tasks run order-1 (parity: thickness_train.py:106)")
        self.device = resolve_device(device)
        kw = {} if tets_dir is None else {"tets_dir": tets_dir}
        verts, tets = load_background_grid(grid_res, **kw)
        self.grid_verts = verts.astype(np.float64) * scale
        self.marching = MarchingTets(self.grid_verts, tets, device=self.device)
        self.pos = torch.as_tensor(self.grid_verts, device=self.device)
        self.mat = Material.of(mat)
        self.mode_num = mode_num
        self.order = order
        self.dtype = default_dtype(self.device)
        self.sigma = 20000.0  # the shift of the host solve
        self.extra_modes = 6  # the rigid block
        if eig_method == "warm":
            self.warm = WarmShapeEigensolver(
                self.marching.num_grid_verts + self.marching.num_edges,
                mode_num + self.extra_modes, dtype=self.dtype, device=self.device,
            )
        else:
            self.warm = None

    # material (density-normalized)
    def _lame(self):
        return lame_params(self.mat.youngs / self.mat.density, self.mat.poisson)

    def _march(self, sdf, thickness):
        return self.marching(self.pos, sdf, thickness)

    def _coef_sdf(self, c):
        """(sdf, thickness) of the marched geometry at coefficient c."""
        raise NotImplementedError

    def _march_coef(self, c):
        """Marching output as a differentiable function of the task's scalar
        coefficient (thickness coef / morphing coef)."""
        return self._march(*self._coef_sdf(c))

    def _eigensolve_host(self, out, comp, k=None):
        """ARPACK (k modes, by default the task's with the rigid block) on the
        compacted geometry in float64 on the host; returns padded (lam, U)
        as numpy."""
        k = self.mode_num + self.extra_modes if k is None else k
        return eigensolve_host(out, comp, *self._lame(), k, self.sigma)

    def _eigensolve(self, out, comp):
        """Training-loop eigensolve: the warm device path when enabled (cold
        starts fall back to host ARPACK inside the warm solver)."""
        if self.warm is None:
            return self._eigensolve_host(out, comp)
        mu, lam = self._lame()
        return self.warm.solve(
            out, comp, float(mu), float(lam),
            host_solve=lambda n: self._eigensolve_host(out, comp, n),
        )

    # -- scalar-coefficient Gauss-Newton ------------------------------------

    def _vals_of_coef(self, c, comp, U):
        """Ritz-refined eigenvalues (elastic modes) as a differentiable
        function of the scalar coefficient c (a float64 tensor)."""
        verts_c = self.marching.vertices(self.pos, *self._coef_sdf(c), comp["keep_idx"])
        ops = assembly.build_element_ops(
            verts_c, comp["tets"], 1, dtype=self.dtype,
            tet_mask=torch.as_tensor(comp["tet_mask"], dtype=self.dtype, device=self.device),
            gather_idx=padded_gather_transpose(comp),
        )
        mu, lame_l = self._lame()
        U = torch.as_tensor(U, dtype=self.dtype, device=self.device)
        return ritz_refined_eigenvalues(
            lambda x: assembly.k_matvec(ops, x, mu, lame_l),
            lambda x: assembly.m_matvec(ops, x, 1.0),
            U,
        )[self.extra_modes:]

    def _coef(self, c):
        return torch.tensor(float(c), dtype=torch.float64, device=self.device)

    def _coef_vals(self, c: float, comp, U):
        """Values only (loss evaluation and landscape diagnostics)."""
        with torch.no_grad():
            vals = self._vals_of_coef(self._coef(c), comp, U)
        return vals.double().cpu().numpy()

    def _coef_vals_jac(self, c: float, comp, U):
        """(vals(c), dvals/dc) from one forward-mode pass of the Ritz-value
        program, tangent 1 on c.

        At the evaluation point the derivative of the frozen-basis Ritz
        program is the exact eigenvalue derivative (Hellmann-Feynman:
        dtheta_i = y_i^T (dK - theta_i dM) y_i).  Central differences of the
        same program are not: the frozen basis carries an O((h dU/dc)^2)
        curvature error."""
        with torch.no_grad(), fwAD.dual_level():
            c_t = self._coef(c)
            vals = self._vals_of_coef(fwAD.make_dual(c_t, torch.ones_like(c_t)), comp, U)
            primal, tangent = fwAD.unpack_dual(vals)
        return primal.double().cpu().numpy(), tangent.double().cpu().numpy()

    def _true_loss(self, c: float, target) -> float:
        """Full march + eigensolve + Ritz values at c: the trustworthy loss
        of newton_optimize's stall probes."""
        out = self._march_coef(float(c))
        comp = MarchingTets.compact(out)
        lam, U = self._eigensolve(out, comp)
        vals = self._coef_vals(c, comp, U)
        r = (vals - target) / target
        return float(np.mean(r**2))

    def newton_optimize(self, target, iters: int = 40, c0: float = 0.5,
                        max_step: float = 0.08, c_bounds=(0.02, 0.98),
                        tol_dc: float = 5e-4, verbose: bool = True,
                        callback=None, loss_floor: float = 1e-4,
                        probe_step: float = 0.02):
        """Scalar Gauss-Newton on the eigenvalue-matching loss
        mean(((vals(c) - target)/target)^2), a nonlinear least squares in
        one variable.  Each iteration: a true eigensolve at c (warm device
        refresh), the exact Jacobian dvals/dc of the Ritz-value program, and
        the 1-D step dc = -(J.r)/(J.J), clipped to max_step; a step whose
        loss is 4x the best retreats halfway to the best point, and a step
        back onto a visited point bisects the hop.

        Stall rescue: a near-zero proposed step at loss > loss_floor is not
        accepted as convergence outright.  If the backing refresh left a
        suspect residual (_grad_suspect), the next solve re-anchors on the
        host and the iteration is retried; then the true loss is probed at
        c +- probe_step (the frozen-topology derivative cannot see across
        marching-tets topology flips) and the walk continues from an
        improving probe.  At most three rescues.  When the budget runs out
        the result is the best evaluated point.
        """
        target = np.asarray(target, np.float64)
        c = float(c0)
        history = []
        best_loss, best_c = np.inf, c
        rescues = 0
        visited = set()
        for it in range(iters):
            visited.add(round(c, 9))
            t0 = time.perf_counter()
            out = self._march_coef(float(c))
            comp = MarchingTets.compact(out)
            lam, U = self._eigensolve(out, comp)
            vals, dvals = self._coef_vals_jac(c, comp, U)
            r = (vals - target) / target
            loss = float(np.mean(r**2))
            rec = {"iter": it, "loss": loss, "coef": c, "dt": time.perf_counter() - t0}
            if self.warm is not None:
                rec["eig_mode"] = self.warm.last_mode
                rec["eig_iters"] = self.warm.last_iterations
            if loss > 4.0 * best_loss + 1e-12:
                # a demonstrably bad step: retreat halfway toward the best
                c_new = 0.5 * (c + best_c)
                rec["retreat"] = True
            else:
                if loss < best_loss:
                    best_loss, best_c = loss, c
                J = dvals / target
                dc = -float(J @ r) / max(float(J @ J), 1e-30)
                dc = float(np.clip(dc, -max_step, max_step))
                c_new = float(np.clip(c + dc, *c_bounds))
                rec["dc"] = dc
                if round(c_new, 9) in visited and abs(c_new - c) >= tol_dc:
                    # cycle break: bisect a hop back onto a visited point
                    c_new = 0.5 * (c + c_new)
                    rec["bisect"] = True
            history.append(rec)
            if verbose:
                print(f"newton iter {it}: loss {loss:.6f} coef {c:.4f} -> {c_new:.4f} "
                      f"[{rec.get('eig_mode', '-')}/{rec.get('eig_iters', 0)} "
                      f"{rec['dt']:.1f}s]", flush=True)
            if callback:
                callback(it, loss, c)
            # converged: a tiny proposed step from a point that is (or ties)
            # the best seen
            if (abs(c_new - c) < tol_dc and not rec.get("retreat")
                    and loss <= best_loss * 1.02):
                if loss > loss_floor and rescues < 3:
                    rescues += 1
                    if self._grad_suspect():
                        self.warm.request_anchor()
                        if verbose:
                            print(f"newton iter {it}: stalled at loss {loss:.6f} on a "
                                  f"suspect refresh (resid {self.warm.last_resid:.2e}); "
                                  f"re-anchoring", flush=True)
                        continue
                    cand = [float(np.clip(c + s, *c_bounds)) for s in (probe_step, -probe_step)]
                    # a probe clipped onto c itself would re-solve c for nothing
                    probes = sorted({p for p in cand if abs(p - c) > 1e-9})
                    if not probes:
                        c = c_new
                        break
                    probe_losses = [self._true_loss(p, target) for p in probes]
                    j = int(np.argmin(probe_losses))
                    if verbose:
                        desc = " ".join(f"{p:.4f}:{pl:.6f}" for p, pl in zip(probes, probe_losses))
                        print(f"newton iter {it}: stationary at loss {loss:.6f}; probes "
                              f"{desc}", flush=True)
                    if probe_losses[j] < 0.98 * loss:
                        c = probes[j]
                        continue
                c = c_new
                break
            c = c_new
        else:
            # budget exhausted mid-walk: the final c is an unevaluated
            # proposal; return the argmin over the evaluated points
            if best_loss < np.inf:
                c = best_c
        return c, history

    def _grad_suspect(self):
        """True when the warm refresh behind the current gradient did not
        converge (residual above the solver tolerance but below the
        escalation bound that would have forced a host re-solve): such
        gradients were measured pointing uphill on a monotone landscape.
        Gated on the residual, not the iteration count."""
        return (
            self.warm is not None
            and self.warm.last_mode == "warm"
            and self.warm.last_resid > self.warm.tol
        )

    # -- Adam over the coefficient bins -------------------------------------

    def step_loss_grad(self, params, target):
        """One iteration's (loss, grad w.r.t. the bin logits): march,
        compact and eigensolve at the current coefficient, the exact scalar
        derivative of the Ritz values (_coef_vals_jac), chained into the bin
        logits."""
        c = self.bins.coef(params)
        out = self._march_coef(c)
        comp = MarchingTets.compact(out)
        lam, U = self._eigensolve(out, comp)
        tgt = np.asarray(target, np.float64)
        vals, dvals = self._coef_vals_jac(c, comp, U)
        r = (vals - tgt) / tgt
        loss = float(np.mean(r**2))
        dldc = float(2.0 * np.mean(r * dvals / tgt))
        return torch.tensor(loss, dtype=torch.float64), self.bins.grad(params, dldc)

    def _adam(self, params, lr):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        return p, torch.optim.Adam(list(p.values()), lr=lr)

    @staticmethod
    def _apply(opt, p, g):
        for k, v in p.items():
            v.grad = g[k].to(v.dtype)
        opt.step()


@dataclass(frozen=True)
class CoefBins:
    """Weighted value over linspace(0, 1, 32): the thickness or morphing
    coefficient.  Params live on the CPU in float64."""

    num: int = 32

    def init_params(self, generator: torch.Generator, dtype=torch.float64):
        return {"coef_logits": uniform(generator, (self.num,), -1.0, 1.0, dtype)}

    def value(self, params):
        logits = params["coef_logits"]
        vals = torch.linspace(0.0, 1.0, self.num, dtype=logits.dtype, device=logits.device)
        return weighted_value(logits, vals)

    def coef(self, params) -> float:
        with torch.no_grad():
            return float(self.value(params))

    def grad(self, params, scale: float = 1.0):
        """scale * d value / d logits, as a params-shaped dict."""
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = torch.autograd.grad(self.value(p), list(p.values()))
        return {k: scale * gk for k, gk in zip(p, g)}

    def pretrain(self, params, target: float, steps: int = 3000, lr: float = 1e-1):
        """Adam fit of the logits so the value hits `target`
        (dmtet_interpolate.py:366-375)."""
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = torch.optim.Adam(list(p.values()), lr=lr)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            ((self.value(p) - target) ** 2).backward()
            opt.step()
        return {k: v.detach() for k, v in p.items()}


class ThicknessTask(ShapeTaskBase):
    """Shell-thickness inference from modal eigenvalues."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.bins = CoefBins(32)
        self.sdf = None
        self.max_thickness = None

    def apply_sdf(self, mesh_verts, mesh_faces):
        self.sdf = mesh_signed_distance(self.grid_verts, mesh_verts, mesh_faces, self.device)
        self.max_thickness = float(self.sdf.max())

    def _coef_sdf(self, c):
        return self.sdf, c * self.max_thickness

    def eigenvalues(self, thickness_coef: float):
        """No-grad target eigenvalues at a given coefficient
        (dmtet_thickness.py:319-324)."""
        out = self._march(self.sdf, thickness_coef * self.max_thickness)
        comp = MarchingTets.compact(out)
        vals, _ = self._eigensolve_host(out, comp)
        return vals[self.extra_modes:]

    def optimize(self, target, iters: int = 500, lr: float = 2e-2, verbose=True,
                 callback=None, params=None):
        """Adam loop (thickness_train.py:42-90) from `params`, by default the
        bins drawn from a generator seeded 0.  A step whose refresh is
        suspect (_grad_suspect) is skipped; after three skips in a row the
        next solve re-anchors on the host."""
        if params is None:
            params = self.bins.init_params(torch.Generator().manual_seed(0))
        p, opt = self._adam(params, lr)
        history = []
        consec_skips = 0
        for it in range(iters):
            t0 = time.perf_counter()
            loss, g = self.step_loss_grad(p, target)
            skipped = self._grad_suspect()
            if skipped:
                consec_skips += 1
                if consec_skips >= 3 and self.warm is not None:
                    print(f"iter {it}: {consec_skips} consecutive suspect "
                          "refreshes - forcing host re-anchor", flush=True)
                    self.warm.request_anchor()
                    consec_skips = 0
            else:
                consec_skips = 0
                self._apply(opt, p, g)
            coef = self.bins.coef(p)
            dt = time.perf_counter() - t0
            rec = {"iter": it, "loss": float(loss), "coef": coef, "dt": dt,
                   "skipped": skipped}
            if self.warm is not None:
                rec["eig_mode"] = self.warm.last_mode
                rec["eig_iters"] = self.warm.last_iterations
            history.append(rec)
            if verbose and it % 10 == 0:
                extra = f" [{rec.get('eig_mode', '-')}/{rec.get('eig_iters', 0)} {dt:.1f}s]"
                print(f"iter {it}: loss {float(loss):.6f} coef {coef:.4f}{extra}", flush=True)
            if callback:
                callback(it, float(loss), coef)
        return {k: v.detach() for k, v in p.items()}, history


class MorphingTask(ShapeTaskBase):
    """Morphing-coefficient inference: sdf = c sdf1 + (1-c) sdf2."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.bins = CoefBins(32)
        self.sdf1 = None
        self.sdf2 = None

    def apply_sdf2(self, verts1, faces1, verts2, faces2):
        self.sdf1 = mesh_signed_distance(self.grid_verts, verts1, faces1, self.device)
        self.sdf2 = mesh_signed_distance(self.grid_verts, verts2, faces2, self.device)

    def blended_sdf(self, coef):
        return coef * self.sdf1 + (1.0 - coef) * self.sdf2

    def _coef_sdf(self, c):
        return self.blended_sdf(c), None

    def eigenvalues(self, coef: float):
        out = self._march(self.blended_sdf(coef), None)
        comp = MarchingTets.compact(out)
        vals, _ = self._eigensolve_host(out, comp)
        return vals[self.extra_modes:]

    def optimize(self, target, iters: int = 10, lr: float = 2e-2, verbose=True,
                 init_coef: Optional[float] = None, params=None):
        """Adam loop from `params` (default: bins drawn from a generator
        seeded 0), pretrained to `init_coef` when given; suspect steps are
        skipped."""
        if params is None:
            params = self.bins.init_params(torch.Generator().manual_seed(0))
        if init_coef is not None:
            params = self.bins.pretrain(params, init_coef)
        p, opt = self._adam(params, lr)
        history = []
        for it in range(iters):
            loss, g = self.step_loss_grad(p, target)
            skipped = self._grad_suspect()
            if not skipped:
                self._apply(opt, p, g)
            coef = self.bins.coef(p)
            history.append({"iter": it, "loss": float(loss), "coef": coef,
                            "skipped": skipped})
            if verbose:
                print(f"iter {it}: loss {float(loss):.6f} coef {coef:.4f}")
        return {k: v.detach() for k, v in p.items()}, history
