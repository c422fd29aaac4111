"""Joint image + audio shape inference experiment CLI.

Counterpart of `diffsound_tpu/experiments/joint.py`, with self-generated
supervision:

  1. the ground truth, a union of two spheres, as an SDF on the DMTet grid
     -> marched mesh -> (a) multi-view PBR renders under the initial
     appearance, (b) modal eigenvalue targets (cold host ARPACK);
  2. the start: both split MLPs regressed to a centred sphere (800 steps);
  3. joint optimisation of image MSE + regularizers + the relative
     eigenvalue loss, streaming the metrics per iteration.

Writes `<out_dir>/result.txt` (one JSON line appended), `render_target.png`,
`render_initial.png`, `render_final.png` (view 0), `best_mesh.obj` (the best
mesh's boundary) and `metrics.jsonl`.

Run: python -m diffsound_torch.experiments.joint --config configs/joint_train.json
(add --device cpu, or "device": "cpu" in the JSON, to run on the CPU; the
default is CUDA)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..fem.mesh import surface_triangles, write_obj
from ..geometry.joint_task import JointImageAudioTask
from ..geometry.dmtet import MarchingTets
from ..render.util import save_image
from ..utils.logging import MetricLogger


def look_at_mvp(campos, fov=0.7, aspect=1.0, near=0.1, far=100.0):
    """OpenGL projection x view of a camera at `campos` looking at the
    origin (y flipped by the projection), float64 numpy."""
    campos = np.asarray(campos, np.float64)
    fwd = -campos / np.linalg.norm(campos)
    upw = np.array([0.0, 1.0, 0.0])
    if abs(fwd @ upw) > 0.95:
        upw = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, upw)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = right, up, -fwd
    view[:3, 3] = -view[:3, :3] @ campos
    f = 1.0 / np.tan(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = f / aspect
    proj[1, 1] = -f
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = 2 * far * near / (near - far)
    proj[3, 2] = -1.0
    return proj @ view


def ring_cameras(n: int, radius: float, height: float = 0.35):
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        campos = np.array([radius * np.cos(a), height, radius * np.sin(a)])
        out.append({"campos": campos, "mvp": look_at_mvp(campos)})
    return out


def gt_sdf_two_spheres(pts, r1=0.32, c1=(-0.15, 0.0, 0.0), r2=0.24, c2=(0.22, 0.05, 0.0)):
    """Inside-positive union of two spheres at points (n, 3)."""
    d1 = r1 - np.linalg.norm(pts - np.asarray(c1), axis=-1)
    d2 = r2 - np.linalg.norm(pts - np.asarray(c2), axis=-1)
    return np.maximum(d1, d2)


def render_target_views(task: JointImageAudioTask, params, out, cams, resolution):
    """Render a march under the appearance params (no jitter): a list of
    {'img' (H, W, 4) float32 numpy: colour x alpha, alpha; 'mvp', 'campos'}."""
    tric, v_tex, t_tex_idx, gidx = task.surface(out)
    views = []
    with torch.no_grad():
        for cam in cams:
            buffers, alpha = task._render_buffers(
                out.all_verts, tric["tris"], tric["tri_mask"], v_tex, t_tex_idx, params,
                cam["mvp"], cam["campos"], resolution, gidx=gidx)
            img = torch.cat([buffers["shaded"][..., :3] * alpha, alpha], dim=-1)
            views.append({"img": img.cpu().numpy().astype(np.float32), **cam})
    return views


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags(
        "joint image+audio (diffsound-torch)",
        defaults={"grid_res": 24, "mode_num": 8, "iter": 300, "n_views": 8, "resolution": 128,
                  "audio_weight": 0.2, "cam_radius": 2.7, "mesh_scale": 1.0,
                  "out_dir": "out/joint/", "hidden_dim": 128, "light_res": 16,
                  "device": "cuda"},
        argv=argv,
    )
    os.makedirs(flags.out_dir, exist_ok=True)
    logger = MetricLogger(flags.out_dir)
    res = (flags.resolution, flags.resolution)
    task = JointImageAudioTask(grid_res=flags.grid_res, scale=flags.mesh_scale,
                               mode_num=flags.mode_num, hidden_dim=flags.hidden_dim,
                               light_res=flags.light_res, device=flags.device)
    params = task.init_params(torch.Generator().manual_seed(0))

    # ---- the ground truth -> eigenvalue and image targets
    gt_sd = gt_sdf_two_spheres(task.grid_verts)
    out_gt = task.marching(torch.as_tensor(task.grid_verts, device=task.device),
                           torch.as_tensor(gt_sd, device=task.device))
    comp_gt = MarchingTets.compact(out_gt)
    tvals, _ = task._eigensolve_host(out_gt, comp_gt, flags.mode_num + task.extra_modes)
    target_vals = tvals[task.extra_modes:]
    print(f"GT mesh: {comp_gt['num_verts']} verts, {comp_gt['num_tets']} tets; "
          f"vals[:4] {np.asarray(target_vals)[:4]}")
    cams = ring_cameras(flags.n_views, flags.cam_radius)
    targets = render_target_views(task, params, out_gt, cams, res)

    # ---- the start: sphere regression of both nets
    params = dict(params)
    params["geo"] = task.geo.pretrain_regression(
        params["geo"], task.grid_verts, 0.35 - np.linalg.norm(task.grid_verts, axis=-1),
        iters=800, lr=3e-4)

    def dump_view(tag, p):
        """View 0 under params p as a PNG (a degenerate mesh must not end
        the run)."""
        try:
            v = render_target_views(task, p, task._march_host(p), cams[:1], res)[0]["img"]
            save_image(os.path.join(flags.out_dir, f"render_{tag}.png"),
                       np.clip(v[..., :3], 0.0, 1.0))
        except Exception as e:
            print(f"render dump {tag} failed: {e}")

    save_image(os.path.join(flags.out_dir, "render_target.png"),
               np.clip(targets[0]["img"][..., :3], 0.0, 1.0))
    dump_view("initial", params)

    # ---- joint optimisation; the metrics stream per iteration
    t0 = time.perf_counter()

    def on_iter(rec):
        logger.scalars({kk: rec[kk] for kk in ("loss", "img", "reg", "audio")}, rec["iter"])

    params, best, history = task.optimize(
        params, np.asarray(target_vals), targets, iters=flags.iter,
        audio_weight=flags.audio_weight, resolution=res, verbose=True, on_iter=on_iter)
    wall = time.perf_counter() - t0
    done = [r for r in history if "skipped" not in r]
    first, lowest = done[0], min(done, key=lambda r: r["loss"])
    summary = {
        "iters": len(done),
        "iters_per_sec": len(done) / wall,
        "img_first": first["img"], "img_best": lowest["img"],
        "audio_first": first["audio"], "audio_best": lowest["audio"],
        "best_loss": best["loss"],
        "warm_solves": task.warm.total_warm,
        "cold_solves": task.warm.total_cold,
    }
    print(json.dumps(summary))
    with open(os.path.join(flags.out_dir, "result.txt"), "a") as f:
        f.write(json.dumps(summary) + "\n")
    dump_view("final", params)
    if best.get("verts") is not None:
        write_obj(os.path.join(flags.out_dir, "best_mesh.obj"), best["verts"],
                  surface_triangles(best["tets"]))
    logger.close()
    return summary


if __name__ == "__main__":
    main()
