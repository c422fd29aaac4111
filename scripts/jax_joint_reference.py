"""The JAX package's numbers for the joint phase of `chip_smoke.py`, which
holds the PyTorch port on the card to them (that machine has no JAX).

At the phase's widths (`chip_smoke.JOINT_SPEC`: grid 24, the split SDF MLPs
27 -> 128 x 4 -> 1, 8 modes + 6, 8 ring views at 128^2, light_res 16,
Ceramic), from the JAX package's `JointImageAudioTask` at PRNGKey(0) (the
light cast to float32, the render's dtype):

  * writes that init's texture and light to `chip_smoke.JOINT_INIT` (numpy
    float32), the appearance the phase renders its targets under, and the
    start below (the split MLPs and deform) to `chip_smoke.JOINT_START`,
    where the phase holds the card's float32 pass to the CPU's;
  * the ground truth (`gt_sdf_two_spheres` marched at grid 24): its DOF and
    its eigenvalues (cold host ARPACK);
  * the 8 target views: each view's mean alpha and mean colour, and the
    port's CPU render of the same views from the converted init: its
    largest gap in those means and the pixels whose alpha differs;
  * at the start (both nets regressed toward the 0.35 ball, 800 steps, by
    the JAX package), on its compaction, padded surface and host ARPACK
    basis, with the jitter draw of PRNGKey(noise_seed) and view 0 as the
    target: the JAX package's float32 `_loss_core` against the port's CPU
    float32 pass (the relative gaps of the loss and the image loss, the
    relative norm gaps of each parameter group's gradient), the JAX
    package's own float32 pass against its float64 one (the audio loss
    and each group's gradient), and the port's CPU float32 against its
    float64 (each group's gradient);
  * the image part there: the same float32 passes with the audio term's
    weight 0, each geometry group's gradient, the JAX package's against the
    port's CPU;
  * the same at the port's start (`--port_start`, default
    `chip_smoke.JOINT_PORT_START`: the port's own 800-step pretrain on the
    card, the start of the phase's loop), converted to the JAX package's
    parameters;
  * `optimize` for `iters` iterations at lr_geo from the JAX package's
    start over the 8 views: the iterations that did not fail (the JAX loop
    skips a step that raises), its warm and cold solves, the best image and
    audio losses over the first, and each iteration's losses.

Run on the CPU (about 8 minutes, and 15 to 60 more for the loop, most of
it host ARPACK and the jit compiles of each new bucket signature):

    JAX_PLATFORMS=cpu python -m scripts.jax_joint_reference [--lr_geo 1e-4] [--iters 40]

It prints one JSON line, the numbers `chip_smoke.JAX_JOINT` holds."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from diffsound_tpu.experiments.joint import (  # noqa: E402
    gt_sdf_two_spheres, render_target_views, ring_cameras,
)
from diffsound_tpu.geometry.dmtet import MarchingTets, map_uv  # noqa: E402
from diffsound_tpu.geometry.joint_task import JointImageAudioTask  # noqa: E402

from diffsound_torch.convert import joint_params_from_jax  # noqa: E402
from diffsound_torch.experiments import joint as port_joint  # noqa: E402
from diffsound_torch.geometry.joint_task import JointImageAudioTask as PortTask  # noqa: E402
from diffsound_torch.utils.tree import tree_leaves  # noqa: E402

SPEC = chip_smoke.JOINT_SPEC
GROUPS = ("front", "back", "deform", "tex", "light")


def group(tree, name):
    sub = tree["geo"][name] if name in ("front", "back", "deform") else tree[name]
    return torch.cat([x.reshape(-1).double() for x in tree_leaves(sub)])


def jax_pass(task, params, comp, tric, v_tex, t_tex_idx, lam, U, target, img, cam, key, dtype,
             audio_weight=SPEC["audio_weight"]):
    task.dtype = dtype
    (loss, aux), g = jax.jit(jax.value_and_grad(task._loss_core, has_aux=True),
                             static_argnames=("resolution",))(
        params, jnp.asarray(comp["keep_idx"]), jnp.asarray(comp["tets"]),
        jnp.asarray(comp["tet_mask"], dtype), jnp.asarray(tric["tris"]),
        jnp.asarray(tric["tri_mask"]), jnp.asarray(v_tex), jnp.asarray(t_tex_idx),
        jnp.asarray(lam, dtype), jnp.asarray(U, dtype), jnp.asarray(target, dtype),
        jnp.asarray(img), jnp.asarray(cam["mvp"], jnp.float32),
        jnp.asarray(cam["campos"], jnp.float32), jnp.float32(0.0), key,
        jnp.float32(audio_weight), jnp.float32(0.02), resolution=(SPEC["res"],) * 2)
    return float(loss), [float(a) for a in aux], g


def load_start(path):
    """A start file (`chip_smoke.JOINT_START`'s layout: each net's flax
    Dense kernels and biases, and deform) as the JAX package's geo params."""
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("front_") and k.endswith("_kernel"))
    mlp = lambda side: {"params": {f"Dense_{i}": {
        "kernel": jnp.asarray(data[f"{side}_Dense_{i}_kernel"]),
        "bias": jnp.asarray(data[f"{side}_Dense_{i}_bias"])} for i in range(n)}}
    return {"front": mlp("front"), "back": mlp("back"), "deform": jnp.asarray(data["deform"])}


def gaps_at(task, port, port64, params, gt_vals, target, cam, res, k):
    """At params (JAX's, with their appearance), on their compaction, padded
    surface and host ARPACK basis, the jitter draw of PRNGKey(noise_seed)
    and `target` as view 0: the JAX package's float32 pass against the
    port's CPU float32 (loss, image loss, each group's gradient), each
    package's own float32 pass against its float64 one, the image part
    (the same float32 passes at audio_weight 0: each geometry group's
    gradient, JAX against the port's CPU), and its DOF."""
    out = task._march_host(params)
    comp = MarchingTets.compact(out)
    tric = MarchingTets.compact_triangles_padded(out)
    v_tex, t_tex_idx = map_uv(tric["face_gidx"], out.surf_tris.shape[0])
    lam, U = task._eigensolve_host(out, comp, k)
    key = jax.random.PRNGKey(SPEC["noise_seed"])
    noise = torch.as_tensor(np.array(jax.random.normal(key, res + (3,), jnp.float32)))
    args = (comp, tric, v_tex, t_tex_idx, lam, U, gt_vals, target, cam, key)
    l32, aux32, g32 = jax_pass(task, params, *args, jnp.float32)
    _, aux64, g64 = jax_pass(task, params, *args, jnp.float64)
    task.dtype = jnp.float32
    tp = joint_params_from_jax(jax.tree.map(np.asarray, params))
    pargs = (comp, tric, v_tex, t_tex_idx, lam, U, gt_vals, target, cam["mvp"], cam["campos"],
             0.0, noise, SPEC["audio_weight"], 0.02, res)
    pl, paux, pg = port.loss_grad(tp, *pargs)
    _, _, pg64 = port64.loss_grad(tp, *pargs)
    # the image part: the audio term's weight 0
    _, _, ji = jax_pass(task, params, *args, jnp.float32, audio_weight=0.0)
    task.dtype = jnp.float32
    _, _, pi = port.loss_grad(tp, *pargs[:12], 0.0, *pargs[13:])
    ji = joint_params_from_jax(jax.tree.map(np.asarray, ji))
    jg, jg64 = (joint_params_from_jax(jax.tree.map(np.asarray, g)) for g in (g32, g64))
    rel = lambda a, b: float((a - b).norm() / b.norm())
    return {
        "dof": 3 * comp["num_verts"], "num_tris": tric["num_tris"],
        "f32_gap_loss": abs(pl.item() / l32 - 1), "f32_gap_img": abs(paux[0].item() / aux32[0] - 1),
        **{f"f32_gap_grad_{n}": rel(group(pg, n), group(jg, n)) for n in GROUPS},
        "jax_f32_audio_gap": abs(aux32[2] / aux64[2] - 1), "jax_audio_f64": aux64[2],
        **{f"jax_own_gap_grad_{n}": rel(group(jg, n), group(jg64, n)) for n in GROUPS},
        **{f"port_own_gap_grad_{n}": rel(group(pg, n), group(pg64, n)) for n in GROUPS},
        **{f"img_part_gap_grad_{n}": rel(group(pi, n), group(ji, n))
           for n in ("front", "back", "deform")},
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--lr_geo", type=float, default=SPEC["lr_geo"])
    ap.add_argument("--iters", type=int, default=SPEC["iters"])
    ap.add_argument("--port_start", default=chip_smoke.JOINT_PORT_START,
                    help="the port's start file, or none to skip it")
    opts = ap.parse_args()
    lr_geo = opts.lr_geo
    t_start = time.perf_counter()
    res = (SPEC["res"],) * 2
    k = SPEC["modes"] + 6
    task = JointImageAudioTask(grid_res=SPEC["grid"], mode_num=SPEC["modes"],
                               hidden_dim=SPEC["hidden"], light_res=SPEC["light"])
    params = dict(task.init_params(jax.random.PRNGKey(0)))
    params["light"] = {"base": params["light"]["base"].astype(jnp.float32)}
    appearance = {f"tex_{i}_{n}": np.asarray(layer[n], np.float32)
                  for i, layer in enumerate(params["tex"]) for n in ("w", "b")}
    appearance["light_base"] = np.asarray(params["light"]["base"], np.float32)
    os.makedirs(os.path.dirname(chip_smoke.JOINT_INIT), exist_ok=True)
    np.savez_compressed(chip_smoke.JOINT_INIT, **appearance)

    # the ground truth and its target views
    cpu = jax.devices("cpu")[0]
    gt_sd = gt_sdf_two_spheres(task.grid_verts)
    out_gt = task.marching(jax.device_put(task.grid_verts, cpu), jax.device_put(gt_sd, cpu))
    comp_gt = MarchingTets.compact(out_gt)
    gt_vals = np.asarray(task._eigensolve_host(out_gt, comp_gt, k)[0])[6:]
    cams = ring_cameras(SPEC["views"], SPEC["cam_radius"])
    targets = render_target_views(task, params, out_gt, cams, res)
    alpha_means = [float(t["img"][..., 3].mean()) for t in targets]
    rgb_means = [float(t["img"][..., :3].mean()) for t in targets]

    port = PortTask(grid_res=SPEC["grid"], mode_num=SPEC["modes"], hidden_dim=SPEC["hidden"],
                    light_res=SPEC["light"], device="cpu")
    p_app = joint_params_from_jax(jax.tree.map(np.asarray, params))
    p_out = port.marching(torch.as_tensor(port.grid_verts), torch.as_tensor(gt_sd))
    p_views = port_joint.render_target_views(port, p_app, p_out, cams, res)
    view_gap = max(max(abs(float(a["img"][..., 3].mean()) / b - 1),
                       abs(float(a["img"][..., :3].mean()) / c - 1))
                   for a, b, c in zip(p_views, alpha_means, rgb_means))
    alpha_px = max(int((a["img"][..., 3] != t["img"][..., 3]).sum())
                   for a, t in zip(p_views, targets))

    # the start: both nets regressed toward the 0.35 ball
    params["geo"] = task.geo.pretrain_regression(
        params["geo"], task.grid_verts, 0.35 - np.linalg.norm(task.grid_verts, axis=-1),
        iters=SPEC["pretrain"], lr=SPEC["pretrain_lr"])
    start = {f"{side}_{k}_{n}": np.asarray(v[n], np.float32)
             for side in ("front", "back")
             for k, v in params["geo"][side]["params"].items() for n in ("kernel", "bias")}
    start["deform"] = np.asarray(params["geo"]["deform"], np.float64)
    np.savez_compressed(chip_smoke.JOINT_START, **start)
    port64 = PortTask(grid_res=SPEC["grid"], mode_num=SPEC["modes"], hidden_dim=SPEC["hidden"],
                      light_res=SPEC["light"], dtype=torch.float64, device="cpu")
    at = lambda geo: gaps_at(task, port, port64, {**params, "geo": geo}, gt_vals,
                             targets[0]["img"], cams[0], res, k)
    at_jax_start = at(params["geo"])
    at_port_start = None if opts.port_start == "none" else at(load_start(opts.port_start))

    # the loop
    t0 = time.perf_counter()
    _, _, hist = task.optimize(params, gt_vals, targets, iters=opts.iters, lr_geo=lr_geo,
                               audio_weight=SPEC["audio_weight"], resolution=res, verbose=False)
    opt_s = time.perf_counter() - t0
    hist = hist or [{"img": np.nan, "audio": np.nan}]
    first, low_img, low_audio = hist[0], min(r["img"] for r in hist), min(r["audio"] for r in hist)
    print(json.dumps({
        "dof_gt": 3 * comp_gt["num_verts"], "gt_vals": gt_vals.tolist(),
        "alpha_means": alpha_means, "rgb_means": rgb_means,
        "port_view_gap": view_gap, "port_alpha_pixels": alpha_px,
        "at_jax_start": at_jax_start, "at_port_start": at_port_start,
        "lr_geo": lr_geo, "iters": len(hist), "warm": task.warm.total_warm,
        "cold": task.warm.total_cold, "img_ratio": low_img / first["img"],
        "audio_ratio": low_audio / first["audio"], "img_first": first["img"],
        "audio_first": first["audio"], "img_per_iter": [r.get("img") for r in hist],
        "audio_per_iter": [r.get("audio") for r in hist], "optimize_s": opt_s,
        "seconds": time.perf_counter() - t_start,
    }))


if __name__ == "__main__":
    main()
