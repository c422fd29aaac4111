"""DLMesh: image-only optimisation of a fixed-topology mesh's vertices.

Counterpart of `diffsound_tpu/geometry/dlmesh.py`: the parameters are the
vertex positions of a triangle mesh, its MLP texture and its environment
light; the loss is image MSE on alpha + L1 on masked colour, a Laplacian
regularizer (absolute, or relative to the initial mesh, annealed by
max(0, 1 - t)) and the albedo-smoothness, visibility and white-balance
regularizers.  Normals and the Laplacian sum through one host-built
transpose on the card (`render.mesh.vertex_sum`)."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..render import mesh as rmesh
from ..render.image_loss import abs_l1
from ..render.light import EnvironmentLight
from ..render.regularizer import laplace_regularizer_const
from ..render.render import render_mesh
from ..utils.tree import detach_tree, fresh_leaves


class DLMesh:
    def __init__(self, base_mesh: rmesh.Mesh, light: EnvironmentLight, material: dict,
                 laplace: str = "relative", laplace_scale: float = 10000.0,
                 total_iters: int = 1000, device="cuda"):
        self.device = resolve_device(device)
        base_mesh = base_mesh.to(self.device)
        self.initial_v_pos = base_mesh.v_pos.detach()
        self.base = base_mesh
        self.light = light
        self.material = material
        self.laplace = laplace
        self.laplace_scale = laplace_scale
        self.total_iters = total_iters
        self._gidx = (rmesh.gather_index(base_mesh.t_pos_idx, base_mesh.v_pos.shape[0])
                      if self.device.type == "cuda" else None)

    def init_params(self, tex_params, light_params):
        """The vertices, the texture's and the light's params on the device."""
        to = lambda d: {k: v.to(self.device) for k, v in d.items()}
        return {"v_pos": self.initial_v_pos.clone(), "tex": to(tex_params),
                "light": to(light_params)}

    def get_mesh(self, v_pos) -> rmesh.Mesh:
        m = rmesh.auto_normals(self.base.with_(v_pos=v_pos, material=self.material), self._gidx)
        if m.v_tex is not None:
            m = rmesh.compute_tangents(m, self._gidx)
        return m

    def render(self, params, mvp, campos, resolution, background=None, bsdf=None,
               generator=None, spp: int = 1):
        return render_mesh(self.get_mesh(params["v_pos"]), {"kd_ks_normal": params["tex"]},
                           self.light, params["light"], mvp, campos, resolution,
                           background=background, bsdf=bsdf, generator=generator, spp=spp)

    def tick(self, params, target_img, mvp, campos, iteration, resolution, generator=None):
        """-> (img_loss, reg_loss)."""
        buffers = self.render(params, mvp, campos, resolution, generator=generator)
        t_iter = iteration / self.total_iters
        shaded = buffers["shaded"]
        a = target_img[..., 3:]
        img_loss = ((shaded[..., 3:] - a) ** 2).mean()
        img_loss = img_loss + abs_l1(shaded[..., :3] * a - target_img[..., :3] * a).mean()
        lap_v = params["v_pos"] if self.laplace == "absolute" else (
            params["v_pos"] - self.initial_v_pos)
        # the anneal stops at zero: past total_iters a negative weight would
        # turn the regularizer into a reward
        reg = laplace_regularizer_const(lap_v, self.base.t_pos_idx, self._gidx) * (
            self.laplace_scale * max(0.0, 1.0 - t_iter))
        ramp = min(1.0, iteration / 500.0)
        reg = reg + (buffers["kd_grad"][..., :-1]
                     * buffers["kd_grad"][..., -1:]).mean() * 0.03 * ramp
        reg = reg + (buffers["occlusion"][..., :-1]
                     * buffers["occlusion"][..., -1:]).mean() * 0.001 * ramp
        reg = reg + self.light.regularizer(params["light"]) * 0.005
        return img_loss, reg

    def optimize(self, params, targets, iters: int = 1000, lr: float = 1e-3,
                 resolution=(128, 128), seed: int = 0, verbose: bool = True, log_every: int = 50):
        """Adam at lr * 0.9^(update // 100) over every parameter; the jitter
        comes from a generator on the device seeded `seed`.  Returns (params,
        history)."""
        p, leaves = fresh_leaves(params)
        opt = torch.optim.Adam(leaves, lr=lr)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 0.9 ** (n // 100))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device)
        views = [{k: as_t(t[k]) for k in ("img", "mvp", "campos")} for t in targets]
        history = []
        for it in range(iters):
            tgt = views[it % len(views)]
            il, rl = self.tick(p, tgt["img"], tgt["mvp"], tgt["campos"], it, resolution, gen)
            loss = il + rl
            for leaf, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                leaf.grad = g
            opt.step()
            sched.step()
            history.append({"iter": it, "loss": loss.item(), "img": il.item(), "reg": rl.item()})
            if verbose and it % log_every == 0:
                r = history[-1]
                print(f"iter {it}: loss {r['loss']:.5f} img {r['img']:.5f} reg {r['reg']:.5f}")
        return detach_tree(p), history
