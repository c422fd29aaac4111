"""How far the joint pass's gradients move under two perturbations of its
float32 arithmetic, on the CPU, at `chip_smoke.joint_phase`'s widths and
at its two starts (`chip_smoke.JOINT_START`, the JAX package's, and
`chip_smoke.JOINT_PORT_START`, the port's), each with its own march,
compaction, surface and host ARPACK basis, view 0 of the phase's targets
and a seeded jitter draw:

  * TF32 products: every float32 `F.linear` and `@` with both operands
    rounded to TF32's 10 mantissa bits (what
    `torch.set_float32_matmul_precision("high")` does on the card, which
    `joint_precision` runs as its control), for the whole pass and for its
    image part (the audio term's weight 0): each group's gradient against
    the unrounded pass, in relative norm;
  * thread counts: the image part under 1, 3 and 6 threads (another
    reduction order): each geometry group's gradient between them.

    python -m scripts.joint_f32_sensitivity

It prints one line per start and pass, and takes a few minutes."""

import torch
import torch.nn.functional as F

import chip_smoke as cs
from diffsound_torch.experiments.joint import (
    gt_sdf_two_spheres, render_target_views, ring_cameras,
)
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.joint_task import JointImageAudioTask

_linear, _matmul = F.linear, torch.Tensor.__matmul__


def tf32(x):
    """x with its float32 mantissa rounded to 10 bits (straight through)."""
    if x.dtype != torch.float32:
        return x
    r = ((x.detach().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def tf32_pass(fn):
    F.linear = lambda x, w, b=None: _linear(tf32(x), tf32(w), b)
    torch.Tensor.__matmul__ = lambda a, b: _matmul(tf32(a), tf32(b))
    try:
        return fn()
    finally:
        F.linear, torch.Tensor.__matmul__ = _linear, _matmul


def rel(a, b, names):
    """Each group's gradient in `a` against `b`, in relative norm."""
    gap = lambda x, y: float((x - y).norm() / y.norm())
    return {n: f"{gap(cs.joint_group(a, n), cs.joint_group(b, n)):.3e}" for n in names}


def main():
    spec = cs.JOINT_SPEC
    res = (spec["res"],) * 2
    task = JointImageAudioTask(grid_res=spec["grid"], mode_num=spec["modes"],
                               hidden_dim=spec["hidden"], light_res=spec["light"], device="cpu")
    k = spec["modes"] + task.extra_modes
    out_gt = task.marching(torch.as_tensor(task.grid_verts),
                           torch.as_tensor(gt_sdf_two_spheres(task.grid_verts)))
    gt = task._eigensolve_host(out_gt, MarchingTets.compact(out_gt), k)[0][task.extra_modes:]
    params = task.init_params(torch.Generator().manual_seed(0))
    params.update(cs.joint_appearance("cpu"))
    view = render_target_views(task, params, out_gt,
                               ring_cameras(spec["views"], spec["cam_radius"]), res)[0]
    geo = ("front", "back", "deform")
    for where, path in (("the JAX package's start", cs.JOINT_START),
                        ("the port's start", cs.JOINT_PORT_START)):
        start = cs.joint_start("cpu", path)
        out = task._march_host(start)
        comp = MarchingTets.compact(out)
        tric, v_tex, t_tex_idx, _ = task.surface(out)
        lam, U = task._eigensolve_host(out, comp, k)
        noise = torch.randn(res + (3,), generator=torch.Generator().manual_seed(
            spec["noise_seed"]))
        args = (comp, tric, v_tex, t_tex_idx, lam, U, gt, view["img"], view["mvp"],
                view["campos"], 0.0, noise)
        torch.set_num_threads(2)
        for label, w in (("whole pass", spec["audio_weight"]), ("image part", 0.0)):
            run = lambda: task.loss_grad(start, *args, w, 0.02, res)
            base, em = run(), tf32_pass(run)
            print(f"{where}, {label}, TF32 products against f32: image loss "
                  f"{abs(em[1][0].item() / base[1][0].item() - 1):.3e}, gradients "
                  f"{rel(em[2], base[2], cs.JOINT_GROUPS)}", flush=True)
        runs = {}
        for threads in (1, 3, 6):
            torch.set_num_threads(threads)
            runs[threads] = task.loss_grad(start, *args, 0.0, 0.02, res)[2]
        print(f"{where}, image part, between thread counts: " + ", ".join(
            f"{a} and {b} {rel(runs[a], runs[b], geo)}" for a, b in ((1, 3), (1, 6), (3, 6))),
            flush=True)


if __name__ == "__main__":
    main()
