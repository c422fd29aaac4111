"""Joint image + audio inverse rendering: one SDF shaped by a differentiable
PBR image loss and the modal-eigenvalue audio loss at once.

Counterpart of `diffsound_tpu/geometry/joint_task.py`:

  * a front/back split SDF (two MLPs selected by a z threshold) and a
    bounded per-vertex deform: the back, unseen side is shaped mostly by
    sound, the front by images;
  * marching tets gives both the render surface (UV-atlased triangles,
    `map_uv`) and the FEM tet mesh from one differentiable vertex array, so
    image and eigenvalue gradients meet in the same parameters;
  * the loss: image MSE (alpha, and masked colour through the pluggable
    image loss) + SDF sign, albedo-smoothness, visibility and light
    white-balance regularizers + the relative eigenvalue MSE of the
    Rayleigh-corrected eigenvalues (`rayleigh_corrected_eigenvalues`).

Per iteration: the march runs detached in float64 on the device and is
compacted on the host (tets, and the surface triangles bucket-padded with
their global vertex ids); the eigenpairs come from the warm device solver
(host ARPACK for cold starts and every REANCHOR_EVERY warm solves); the loss
and its gradient in every parameter come from one reverse-mode pass.  The
render runs in float32 (`_render_buffers`); the march and the FEM in the
task's dtype.  Smooth normals are summed without atomics on the card
(`render.mesh.vertex_sum`)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..fem import assembly
from ..fem.material import Material, MatSet, lame_params
from ..render.image_loss import make_image_loss
from ..render.light import EnvironmentLight
from ..render.mesh import gather_index, vertex_sum
from ..render.mlptexture import MLPTexture3D
from ..render.rasterize import interpolate, interpolate_face, rasterize
from ..render.render import shade
from ..render.util import safe_normalize, xfm_points
from ..solvers.diff_eigs import rayleigh_corrected_eigenvalues
from ..utils.tree import detach_tree, fresh_leaves, tree_leaves, tree_unflatten
from .dmtet import MarchingTets, map_uv, sdf_reg_loss
from .geometry_task import _Clock
from .grid import load_background_grid
from .sdf_mlp import SDFNet, cast_params, train_sdf_regression
from .tasks import eigensolve_host
from .warm_eigs import WarmShapeEigensolver, padded_gather_transpose


class SplitSDFGeometry:
    """Front/back split neural SDF + bounded deform over a background grid.

    Params: {"front": MLP dict, "back": MLP dict, "deform": (V, 3)}, each MLP
    an `SDFNet` parameter dict."""

    def __init__(self, grid_verts: np.ndarray, grid_res: int, scale: float = 1.0,
                 freq_num: int = 4, hidden_dim: int = 256, layer_num: int = 3,
                 z_threshold: float = -0.2, device="cuda"):
        self.device = resolve_device(device)
        self.verts = torch.as_tensor(np.asarray(grid_verts, np.float64), device=self.device)
        self.grid_res = grid_res
        self.scale = scale
        self.z_threshold = z_threshold
        self.net = SDFNet(freq_num, scale, layer_num, hidden_dim)
        self.deform_bound = scale * 1.8 / (grid_res * 2)

    def init_params(self, generator: torch.Generator):
        """The MLPs in float32 and deform in float64, as the JAX package's
        (flax's float32 parameters, deform shaped like the float64 grid)."""
        return {
            "front": self.net.init_params(generator, torch.float32, self.device),
            "back": self.net.init_params(generator, torch.float32, self.device),
            "deform": torch.zeros(self.verts.shape, dtype=torch.float64, device=self.device),
        }

    def deformed_verts(self, params):
        deform = params["deform"]
        return self.verts.to(deform.dtype) + self.deform_bound * torch.tanh(deform)

    def sdf_at(self, params, points):
        """Both nets evaluate; z selects (the front at z >= z_threshold)."""
        sf = self.net.evaluate(params["front"], points / self.scale)
        sb = self.net.evaluate(params["back"], points / self.scale)
        return torch.where(points[..., 2] >= self.z_threshold, sf, sb)

    def sdf(self, params):
        return self.sdf_at(params, self.deformed_verts(params))

    def pretrain_regression(self, params, points, sdf_vals, **kw):
        """SDF regression of both nets to the same samples
        (`train_sdf_regression`, each from the same seed)."""
        params = dict(params)
        for side in ("front", "back"):
            dt = params[side]["layers.0.weight"].dtype
            pts = torch.as_tensor(np.asarray(points) / self.scale, dtype=dt, device=self.device)
            params[side] = train_sdf_regression(self.net, params[side], pts, sdf_vals, **kw)
        return params


def masked_auto_normals(v_pos, tris, tri_mask, gidx: Optional[torch.Tensor] = None):
    """Smooth vertex normals and unit face normals over a capacity-padded
    triangle set; `gidx` (`render.mesh.gather_index` of the real
    triangles) sums them on the card."""
    t = tris.long()
    v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0) * tri_mask[:, None]
    v_nrm = vertex_sum(fn.repeat_interleave(3, dim=0), t, v_pos.shape[0], gidx)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v_nrm.dtype, device=v_nrm.device)
    v_nrm = torch.where((v_nrm * v_nrm).sum(-1, keepdim=True) > 1e-20, v_nrm, up)
    return safe_normalize(v_nrm), safe_normalize(fn + 1e-20)


class JointImageAudioTask:
    # a host re-anchor after this many warm solves in a row
    REANCHOR_EVERY = 50
    # LOBPCG iterations of a warm round (two rounds before a host re-anchor):
    # at grid 24 the joint loop's meshes (20-50k DOF) often need 250-480
    # iterations to reach the acceptance residual, and a re-anchor there
    # costs 25-65 s of host ARPACK against ~2 s for 240 more iterations
    # (on an H100 and its host)
    WARM_MAX_ITERS = 480

    def __init__(self, grid_res: int = 32, scale: float = 1.0, mode_num: int = 16,
                 mat=MatSet.Ceramic, freq_num: int = 4, hidden_dim: int = 256,
                 z_threshold: float = -0.2, light_res: int = 32, tets_dir: Optional[str] = None,
                 dtype=torch.float32, device="cuda"):
        """dtype: the differentiable march's and the FEM's in the loss (the
        SDF is evaluated in float64, the detached march is float64 and the
        render float32 whatever it is)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        kw = {} if tets_dir is None else {"tets_dir": tets_dir}
        verts, tets = load_background_grid(grid_res, **kw)
        self.grid_verts = verts.astype(np.float64) * scale
        self.marching = MarchingTets(self.grid_verts, tets, device=self.device)
        self.geo = SplitSDFGeometry(self.grid_verts, grid_res, scale, freq_num, hidden_dim,
                                    z_threshold=z_threshold, device=self.device)
        self.mat = Material.of(mat)
        self.mode_num = mode_num
        self.sigma = 20000.0  # the shift of the host solve
        self.extra_modes = 6  # the rigid block
        aabb = (self.grid_verts.min(0) - 0.1, self.grid_verts.max(0) + 0.1)
        self.texture = MLPTexture3D(aabb)
        self.light = EnvironmentLight(base_res=light_res)
        self.material = {"kd_ks_normal": self.texture, "bsdf": "pbr"}
        # the colour loss: the JAX package's default of its pluggable family
        self.img_loss_fn = make_image_loss("mse")
        self._edges = torch.as_tensor(self.marching.unique_edges, device=self.device)
        self.warm = WarmShapeEigensolver(
            self.marching.num_grid_verts + self.marching.num_edges, mode_num + self.extra_modes,
            dtype=default_dtype(self.device), device=self.device,
            reanchor_every=self.REANCHOR_EVERY, max_iters=self.WARM_MAX_ITERS)

    def _lame(self):
        return lame_params(self.mat.youngs / self.mat.density, self.mat.poisson)

    def init_params(self, generator: torch.Generator):
        return {
            "geo": self.geo.init_params(generator),
            "tex": self.texture.init_params(generator, device=self.device),
            "light": self.light.init_params(generator, device=self.device),
        }

    # -- detached march and eigensolve --------------------------------------

    def _march_host(self, params):
        """The march of params' geometry in float64, detached."""
        with torch.no_grad():
            geo = cast_params(params["geo"], torch.float64)
            return self.marching(self.geo.deformed_verts(geo), self.geo.sdf(geo))

    def _eigensolve_host(self, out, comp, k):
        return eigensolve_host(out, comp, *self._lame(), k, self.sigma)

    def _tri_gather(self, tric):
        """The surface's vertex_sum transpose on the card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        n_slots = self.marching.num_grid_verts + self.marching.num_edges
        return gather_index(torch.as_tensor(tric["tris"], device=self.device), n_slots,
                            tric["num_tris"])

    # -- the differentiable loss --------------------------------------------

    def _render_buffers(self, all_verts, tris, tri_mask, v_tex, t_tex_idx, params, mvp, campos,
                        resolution, noise=None, gidx=None):
        """Shaded G-buffers of one view in float32 and the straight-through
        coverage alpha (H, W, 1).  noise: the jitter draw (H, W, 3), or None
        for no jitter."""
        dev = all_verts.device
        tris = torch.as_tensor(tris, device=dev)
        tri_mask = torch.as_tensor(tri_mask, device=dev)
        v_pos = all_verts.float()
        v_clip = xfm_points(v_pos, torch.as_tensor(np.asarray(mvp), dtype=torch.float32,
                                                   device=dev))
        rast = rasterize(v_clip, tris, resolution, tri_mask=tri_mask, num_layers=1)[0]
        v_nrm, f_nrm = masked_auto_normals(v_pos, tris, tri_mask.float(), gidx)
        gb_pos = interpolate(v_pos, rast, tris)
        gb_nrm = interpolate(v_nrm, rast, tris)
        gb_geom = interpolate_face(f_nrm, rast)
        gb_tng = gb_pos.new_tensor([1.0, 0.0, 0.0]).expand(gb_pos.shape)
        gb_texc = interpolate(torch.as_tensor(v_tex, device=dev), rast,
                              torch.as_tensor(t_tex_idx, device=dev))
        view_pos = torch.as_tensor(np.asarray(campos), dtype=torch.float32,
                                   device=dev).reshape(1, 1, 3)
        buffers = shade(gb_pos, gb_geom, gb_nrm, gb_tng, gb_texc, view_pos, self.light,
                        params["light"], self.material, {"kd_ks_normal": params["tex"]},
                        noise=noise)
        return buffers, rast.alpha_soft[..., None]

    def vertices(self, geo):
        """The differentiable vertex array of the march (every row: the
        render's triangles hold global ids) and the SDF, in the task's
        dtype.  The SDF is evaluated in float64, as the detached march's,
        and only then cast: a float32 evaluation can flip the sign of a
        value near zero, and an edge point of the march's fixed topology
        then collapses onto a corner."""
        geo = cast_params(geo, torch.float64)
        pos = self.geo.deformed_verts(geo).to(self.dtype)
        sdf = self.geo.sdf(geo).to(self.dtype)
        return self.marching.vertices(pos, sdf, None), sdf

    def _loss_core(self, params, comp, tric, v_tex, t_tex_idx, lam, U, target_vals, target_img,
                   mvp, campos, t_iter, noise, audio_weight, sdf_regularizer, resolution,
                   tri_gidx=None):
        """(total, (img_loss, reg, audio_loss)) at params on the compaction
        `comp`, the padded surface `tric` and the detached eigenpairs (lam,
        U)."""
        dt, dev = self.dtype, self.device
        all_verts, sdf = self.vertices(params["geo"])

        # ---- image loss: alpha MSE + the colour loss on masked colours
        buffers, alpha = self._render_buffers(all_verts, tric["tris"], tric["tri_mask"], v_tex,
                                              t_tex_idx, params, mvp, campos, resolution, noise,
                                              tri_gidx)
        target_img = torch.as_tensor(target_img, dtype=torch.float32, device=dev)
        pred_rgb = buffers["shaded"][..., :3] * alpha
        ref_a = target_img[..., 3:]
        img_loss = ((alpha - ref_a) ** 2).mean() + self.img_loss_fn(
            pred_rgb, target_img[..., :3] * ref_a)

        # ---- regularizers
        sdf_weight = sdf_regularizer - (sdf_regularizer - 0.01) * min(1.0, 4.0 * t_iter)
        ramp = min(1.0, 2.0 * t_iter)
        reg = sdf_reg_loss(sdf, self._edges) * sdf_weight
        reg = reg + (buffers["kd_grad"][..., :-1]
                     * buffers["kd_grad"][..., -1:]).mean() * 0.03 * ramp
        reg = reg + (buffers["occlusion"][..., :-1]
                     * buffers["occlusion"][..., -1:]).mean() * 0.001 * ramp
        reg = reg + self.light.regularizer(params["light"]) * 0.005

        # ---- audio loss: relative MSE of the corrected eigenvalues
        verts_c = all_verts[torch.as_tensor(comp["keep_idx"], device=dev)]
        ops = assembly.build_element_ops(
            verts_c, comp["tets"], 1, dtype=dt,
            tet_mask=torch.as_tensor(comp["tet_mask"], dtype=dt, device=dev),
            gather_idx=padded_gather_transpose(comp))
        mu, lame_l = self._lame()
        vals = rayleigh_corrected_eigenvalues(
            lambda x: assembly.k_matvec(ops, x, mu, lame_l),
            lambda x: assembly.m_matvec(ops, x, 1.0),
            torch.as_tensor(np.asarray(lam), dtype=dt, device=dev),
            torch.as_tensor(U, dtype=dt, device=dev),
        )[self.extra_modes:]
        target = torch.as_tensor(np.asarray(target_vals), dtype=dt, device=dev)
        audio_loss = ((vals - target) ** 2 / target**2).mean()
        total = img_loss + reg + audio_weight * audio_loss
        return total, (img_loss, reg, audio_loss)

    def loss_grad(self, params, *args, **kw):
        """(loss, (img, reg, audio), grads shaped like params): one
        reverse-mode pass of `_loss_core(params, *args, **kw)`."""
        p, leaves = fresh_leaves(params)
        loss, aux = self._loss_core(p, *args, **kw)
        g = torch.autograd.grad(loss, leaves)
        return loss.detach(), tuple(a.detach() for a in aux), tree_unflatten(params, list(g))

    def surface(self, out, tri_bucket: int = 2048):
        """The render inputs of a march: (padded triangles, v_tex,
        t_tex_idx, the card's normal-sum transpose)."""
        tric = MarchingTets.compact_triangles_padded(out, tri_bucket)
        v_tex, t_tex_idx = map_uv(tric["face_gidx"], out.surf_tris.shape[0])
        return tric, v_tex, t_tex_idx, self._tri_gather(tric)

    def step_loss_grad(self, params, target_vals, target_img, mvp, campos, t_iter, noise=None,
                       audio_weight=1.0, sdf_regularizer=0.02, resolution=(128, 128),
                       tri_bucket=2048):
        """One iteration: the detached march and its compactions, the
        eigensolve, the loss and its gradient.  Returns (loss, (img, reg,
        audio), grads, comp, out, timing)."""
        clock = _Clock(self.device)
        clock.mark()
        out = self._march_host(params)
        clock.mark()
        comp = MarchingTets.compact(out)
        clock.mark()
        tric, v_tex, t_tex_idx, tri_gidx = self.surface(out, tri_bucket)
        clock.mark()
        k = len(target_vals) + self.extra_modes
        host_path = k != self.warm.k
        if host_path:
            lam, U = self._eigensolve_host(out, comp, k)
        else:
            mu, lame_l = self._lame()
            lam, U = self.warm.solve(out, comp, float(mu), float(lame_l),
                                     host_solve=lambda n: self._eigensolve_host(out, comp, n))
        clock.mark()
        loss, aux, g = self.loss_grad(params, comp, tric, v_tex, t_tex_idx, lam, U, target_vals,
                                      target_img, mvp, campos, t_iter, noise, audio_weight,
                                      sdf_regularizer, resolution, tri_gidx=tri_gidx)
        clock.mark()
        names = ("march_s", "compact_s", "surface_s", "solve_s", "loss_grad_s")
        timing = dict(zip(names, clock.seconds()))
        timing["solve_mode"] = "host" if host_path else self.warm.last_mode
        timing["solve_iters"] = 0 if host_path else self.warm.last_iterations
        return loss, aux, g, comp, out, timing

    # -- the optimisation loop ---------------------------------------------

    def optimize(self, params, target_vals, targets, iters: int = 500, lr_geo: float = 1e-3,
                 lr_app: float = 1e-2, audio_weight: float = 1.0, resolution=(128, 128),
                 verbose: bool = True, seed: int = 0, log_every: int = 10, on_iter=None):
        """targets: a list of {'img' (H, W, 4), 'mvp', 'campos'}, cycled per
        iteration.  Adam with lr * 0.9^(update // 100), at lr_geo on the
        geometry and lr_app on the texture and the light; the jitter noise
        comes from a generator on the device seeded `seed`.

        on_iter(rec): called with each iteration's metric record.  An
        iteration whose step raises is printed, recorded as {"iter": it,
        "skipped": reason} and takes no update.  Returns (params, best,
        history)."""
        p, leaves = fresh_leaves(params)
        opt = torch.optim.Adam([
            {"params": tree_leaves(p["geo"]), "lr": lr_geo},
            {"params": tree_leaves(p["tex"]) + tree_leaves(p["light"]), "lr": lr_app}])
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 0.9 ** (n // 100))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        imgs = [torch.as_tensor(t["img"], dtype=torch.float32, device=self.device)
                for t in targets]
        history = []
        best = {"loss": math.inf}
        for it in range(iters):
            tgt = targets[it % len(targets)]
            noise = torch.randn((*resolution, 3), generator=gen, device=self.device)
            try:
                loss, (il, rl, al), g, comp, out, timing = self.step_loss_grad(
                    p, target_vals, imgs[it % len(targets)], tgt["mvp"], tgt["campos"],
                    it / max(iters, 1), noise, audio_weight, resolution=resolution)
            except Exception as e:  # a degenerate mesh mid-optimisation
                reason = f"{type(e).__name__}: {e}"
                print(f"iter {it}: step failed ({reason}); skipping", flush=True)
                history.append({"iter": it, "skipped": reason})
                continue
            for leaf, gl in zip(leaves, tree_leaves(g)):
                leaf.grad = gl
            opt.step()
            sched.step()
            rec = {"iter": it, "loss": loss.item(), "img": il.item(), "reg": rl.item(),
                   "audio": al.item(), **timing}
            history.append(rec)
            if on_iter is not None:
                on_iter(rec)
            if rec["loss"] < best["loss"]:
                with torch.no_grad():
                    rows = torch.as_tensor(comp["keep_idx"][: comp["num_verts"]],
                                           device=out.all_verts.device)
                    vc = out.all_verts[rows].cpu().numpy()
                best = {"loss": rec["loss"], "verts": vc, "tets": comp["tets"][: comp["num_tets"]],
                        "img": rec["img"], "audio": rec["audio"]}
            if verbose and it % log_every == 0:
                print(f"iter {it}: loss {rec['loss']:.5f} img {rec['img']:.5f} "
                      f"reg {rec['reg']:.5f} audio {rec['audio']:.5f}", flush=True)
        return detach_tree(p), best, history
