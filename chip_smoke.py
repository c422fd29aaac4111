#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`diffsound_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of `diffsound_tpu`.  Phases, each of which
fails the run by raising:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every kernel from the sources in the
   checkout (nvcc, sm_90a).
2. Kernel phase: the oscillator-synthesis kernels, forward and backward,
   against their plain PyTorch versions on the card (the backward against
   the plain one in float64), at the flagship shape (1, 16, 8000), the
   material_real ground-truth bank (8, 256, 8000) with the trainer's tables
   and with the GT bank's own (damping to 5e4 1/s, over-damped modes), and
   a ragged T (3, 40, 1000), with CUDA-event times of each kernel, of its plain
   version, and of SynthFn's forward and backward against autograd of the
   plain version.
3. Main path at full width: material_sync's `newton` recipe
   (`MaterialSyncTask.make_gt` / `.train_newton`) on `cube_tet_mesh(9,
   0.3)` at order 2 (20,577 DOF; depth cut from 59,049 to leave the time
   limit room for the shape phase), 16 modes, 8000 samples at 32 kHz,
   flagship pair 0: the modal-Newton fit (20 rounds, three extraction
   windows), then a 300-epoch polish (5-scale L1 + 300 x freq-chamfer) with
   an eigensolve refresh every 15.  The launch counts of both kernels are
   zeroed just before and read just after.  Gates: the fit within 2% in E
   and 0.03 in nu of the JAX package's fit of the same pair on this cube
   (which, like the port's, misses the target: see JAX_NEWTON_PAIR0); a
   warm refresh against a host ARPACK solve at the same material; one
   polish step in f32 on the card against the port's f64 on the CPU at the
   same params and eigenvectors.  Then profiles of the
   L1-only and the polish step at that width: host time, device time and
   kernel launches per step.
4. Epoch recipes at full audio width on `cube_tet_mesh(9, 0.3)` at order 2
   (20,577 DOF), from the main path's ground truth: the reference recipe
   (45 Sinkhorn `geomloss` epochs, then 15 L1 epochs) and the default epoch
   recipe (15 freq-chamfer epochs, then 15 of L1 + 300 x chamfer); one
   geomloss step in f32 on the card against the port's f64 on the CPU, at
   the reference run's params and at ten seeded steps, each gated by the
   JAX package's own f32 gap; the Sinkhorn divergence alone in f32 at ten
   seeds and two n_fft, each held to the JAX package's own f32 gap there
   (sinkhorn_f32_gate); the geomloss step's peak memory and profile.
5. CLI phase: `python -m diffsound_torch.experiments.material_sync`'s
   `main` on a small cube mesh written to a .msh file, for each recipe
   (`newton`, `adam`, `reference`).
6. material_real at full audio width on synthetic 8-mic recordings of
   `cube_tet_mesh(9, 0.3)` at order 2 (REAL_GT_FREQS damped by the curve of
   results/r2/material_real_stage1_fit.npz): stage 1 (`fit_gt_oscillator`,
   a 256-mode GT bank, 2001 steps; gates: finite losses ending below the
   JAX package's after 300 steps, 2001 launches of each kernel), its
   step's profile and one step in f32 against the CPU's f64; stage 2
   (`train_material_real` from the r2 curve: the modal-Newton start held
   to the JAX package's, 45 geomloss and 30 L1 epochs whose losses must
   fall), the geomloss and L1 steps' profiles at 8 mics and the geomloss
   step's peak memory; the chained run (stage 1's own curve into stage 2,
   finite values); the material_real CLI, fresh and from its stage-1
   cache.
7. Shape phase at the configs' widths (grid 64, mesh_scale 1.5, Steel,
   order 1, the warm eigensolver) on procedural OBJ meshes: thickness (an
   icosphere, 32 modes, target 0.4: Newton from 0.5 within 0.02 of it,
   then ten Adam steps from the JAX package's PRNGKey(0) bins that must
   move toward it) and morphing (an icosphere and an ellipsoid, 16 modes,
   target 0.7: Newton from 0.5 within 0.05); at c 0.5 on the host basis the
   card's float32 Ritz values and dvals/dc against the JAX package's
   float64 (JAX_SHAPE); after the Adam steps a warm solve across the
   remesh back to 0.4 against the target's host ARPACK solve; the parts'
   times (setup, cold and warm solves, march and compaction, the Ritz pass
   and its peak memory, one Newton iteration's host and device time).  The
   two tasks run at once (morphing in a second process).  Then both shape
   CLIs at grid 16 with each optimizer.  No synthesis kernel runs here: the
   shape loss is the relative eigenvalue mismatch.
8. Geometry phase, in a second process beside the shape phase, at
   `configs/geometry_train.json`'s widths (grid 32, freq_num 3, the SDF MLP
   21 -> 512 x 4 -> 1, 64 + 6 modes, voxel 16, Ceramic, the warm
   eigensolver re-anchoring every 50) on a procedural ground truth (the
   ellipsoid of GEOMETRY_SPEC marched at grid 32 and written as a .msh and
   a surface OBJ): its eigenvalues (cold host ARPACK) against the JAX
   package's, the CLI's voxel constraint, a start pretrained toward the
   ellipsoid x 1.2, 20 optimize iterations at lr 3e-4 (gates: finite
   losses, no skipped iteration, the best mesh's eigenvalue loss below
   iteration 0's), the parts' times per iteration, the card's f32 loss and
   gradients at the start's compaction and host basis against the CPU's
   f64 (the losses and the loss's gradient held to GEOMETRY_F32_MARGIN
   times the JAX package's own f32 gap, JAX_GEOMETRY; the eigenvalue
   loss's gradient in the MLP's parameters to GEOMETRY_EIG_GRAD_GATE, which
   the same pass with TF32 on must fail), the loss-gradient pass's peak
   memory, a warm solve at the final params against host ARPACK with the
   task's solver settings, one iteration's profile, and the geometry CLI at
   grid 16.  No synthesis kernel runs here either.
9. Leftovers phase: the stress path (`k_matvec_stress` through
   `linear_stress`) at order 2 on `cube_tet_mesh(9, 0.3)` in f32 against the
   CPU's f64 `k_matvec`, `TinyNN`'s stress path and f64 jacobian,
   `lobpcg_solver_freq` against ARPACK, and BEM's pulsating sphere and 1/r
   decay in complex64 and complex128.

The line before the last is one JSON object listing every kernel with its
launches on the main path, error, times and bound; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

SR = 32000.0
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# dense TF32 tensor-core operations/s (a multiply-add counts two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_OPS_PER_S = 495e12
# torch.cuda._sleep spins in GPU clock cycles; the H100's boost clock is
# about 2 GHz.
GPU_CYCLES_PER_MS = 2e6


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps: int):
    """Device and host time of fn(), in ms per call.

    The host time is the wall time of reps calls back to back, synchronized
    once at the end: what a caller pays when the device keeps up.  For the
    device time the stream first spins for twice that, so every launch is
    queued before the start event fires and the events time the device's
    work back to back, not the host's rate of enqueueing it.  The launches
    of all reps must fit in the launch queue (about a thousand); when they
    do not, the host enqueues the rest while the device runs, and its rate
    leaks into the reading."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_ms * GPU_CYCLES_PER_MS))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms / reps


def timed(fn, reps: int, rounds: int = 3):
    """cuda_time_ms over several rounds: the device times of all rounds,
    their median, and the median host time per call."""
    runs = [cuda_time_ms(fn, reps) for _ in range(rounds)]
    dev = sorted(r[0] for r in runs)
    host = sorted(r[1] for r in runs)
    return dict(all=[r[0] for r in runs], ms=dev[rounds // 2], host_ms=host[rounds // 2])


def launches_per_call(fn, calls: int = 5) -> int:
    """Kernels of one fn() call on the device, from torch.profiler (copies
    and memsets left out), averaged over several calls and rounded: the
    device's own record, so a kernel launched from a library with its own
    CUDA runtime counts as well; a short window can lose a record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and not e.name.startswith(("Memcpy", "Memset")))
    return max(1, round(kernels / calls))


def synth_bound(A: int, M: int, T: int, backward: bool = False):
    """Least time for work that any implementation of the synthesis must do:
    the inputs read once and the outputs written once (forward: three (A, M)
    tables in, (A, T) out; backward: the tables and the (A, T) cotangent in,
    three (A, M) gradients out), against the mode sum's multiply-adds at the
    TF32 tensor peak (one per (a, m, t) forward, three backward)."""
    if backward:
        nbytes, macs = 4 * (6 * A * M + A * T), 3 * A * M * T
    else:
        nbytes, macs = 4 * (3 * A * M + A * T), A * M * T
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2 * macs / PEAK_TF32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synth_modes(A, M, device, seed):
    """Mode tables shaped like the trainer's: damped frequencies across the
    audible band, Rayleigh damping (alpha 6, beta 1e-7) and amplitudes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = rng.uniform(50.0, 15000.0, (A, M))
    d = 0.5 * (6.0 + 1e-7 * (2 * np.pi * f) ** 2)
    a = rng.uniform(0.1, 1.0, (A, M))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (f, d, a))


def gt_bank_modes(A, M, device, seed):
    """Mode tables as the material_real GT bank makes them, drawn over the
    bank's full range: linear frequencies in [20, 16000] Hz, alpha and beta
    log-uniform over the bank's bins (0.1x to 100x Ceramic's 6 and 1e-7),
    damping (alpha + beta (2 pi f)^2) / 2 up to about 5e4 1/s, the damped
    frequency clamped as `damped_frequency` clamps it where the damping
    exceeds 2 pi f (the first mode of every row: 20 Hz at alpha 600),
    amplitudes as modified_sigmoid makes them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = rng.uniform(20.0, 16000.0, (A, M))
    alpha = np.exp(rng.uniform(np.log(0.6), np.log(600.0), (A, M)))
    beta = np.exp(rng.uniform(np.log(1e-8), np.log(1e-5), (A, M)))
    f[:, 0], alpha[:, 0] = 20.0, 600.0
    lbd = (2 * np.pi * f) ** 2
    d = 0.5 * (alpha + beta * lbd)
    fd = np.sqrt(np.maximum(lbd - d**2, 1e-12)) / (2 * np.pi)
    a = 2.0 / (1.0 + np.exp(-rng.uniform(0.0, 0.04, (A, M)))) ** 2.3 + 1e-6
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (fd, d, a))


def fmt(xs, digits: int = 5):
    return " ".join(f"{x:.{digits}f}" for x in xs)


def kernel_phase(device):
    """Both synthesis kernels against their plain versions; returns the
    figures of each kernel at the flagship shape, the one the main path
    launches."""
    import torch

    from diffsound_torch.audio import synth_kernel
    from diffsound_torch.audio.synth_kernel import (
        SynthFn, synth_constant_modes_bwd_plain, synth_constant_modes_plain,
    )

    flagship = None
    for A, M, T, tables in ((1, 16, 8000, synth_modes), (8, 256, 8000, synth_modes),
                            (3, 40, 1000, synth_modes), (8, 256, 8000, gt_bank_modes)):
        f, d, a = tables(A, M, device, seed=A * 1000 + M)
        shape = f"({A},{M},{T}){' GT bank tables' if tables is gt_bank_modes else ''}"
        if tables is gt_bank_modes:
            log(f"kernel synth {shape}: damping {float(d.min()):.3g} to "
                f"{float(d.max()):.4g} 1/s, {int((f < 1e-3).sum())} modes over-damped (damped "
                f"frequency clamped)")
        with torch.no_grad():
            out = synth_kernel.synth_kernel(f, d, a, T, SR)
            ref = synth_constant_modes_plain(f, d, a, T, SR)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        # f32 sum of M terms, each with an f32-rounded phase and envelope
        bound = 1e-5 * a.abs().sum(dim=1, keepdim=True)
        fwd_err = float(err.max())
        if out.shape != (A, T) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"synth kernel {shape}: bad output {tuple(out.shape)}")
        if not bool((err <= bound).all()):
            raise RuntimeError(
                f"synth kernel {shape}: max |kernel - plain| {fwd_err:.3e} "
                f"exceeds 1e-5 * sum|amp| = {float(bound.min()):.3e}"
            )

        # Backward kernel against the plain backward in f64 (gate: 1e-4 of
        # max|grad| per gradient); the plain backward in f32 is the witness
        # of what f32 alone costs.  SynthFn's backward of <out, w> must hand
        # back the wrapper's gradients bit for bit.
        w = torch.randn((A, T), generator=torch.Generator(device).manual_seed(A + M),
                        device=device)
        with torch.no_grad():
            g_k = synth_kernel.synth_kernel_bwd(f, d, a, w, T, SR)
            g_64 = synth_constant_modes_bwd_plain(f.double(), d.double(), a.double(),
                                                  w.double(), T, SR)
            g_32 = synth_constant_modes_bwd_plain(f, d, a, w, T, SR)
        torch.cuda.synchronize()
        rel = lambda x, y: float((x.double() - y).abs().max() / y.abs().max())
        bwd_rel = [rel(x, y) for x, y in zip(g_k, g_64)]
        plain_rel = [rel(x, y) for x, y in zip(g_32, g_64)]
        bwd_abs = max(float((x.double() - y).abs().max()) for x, y in zip(g_k, g_64))
        if not (all(bool(torch.isfinite(x).all()) for x in g_k) and max(bwd_rel) <= 1e-4):
            raise RuntimeError(f"synth backward kernel {shape}: relative errors "
                               f"{bwd_rel} (f, d, amp) against the f64 plain version")
        ins = [x.clone().requires_grad_(True) for x in (f, d, a)]
        g_fn = torch.autograd.grad((SynthFn.apply(*ins, T, SR) * w).sum(), ins)
        if not all(torch.equal(x, y) for x, y in zip(g_fn, g_k)):
            raise RuntimeError(f"SynthFn {shape}: backward differs from the kernel's")

        def synthfn_step():
            return torch.autograd.grad(SynthFn.apply(*ins, T, SR), ins, w)

        def plain_step():
            return torch.autograd.grad(synth_constant_modes_plain(*ins, T, SR), ins, w)

        with torch.no_grad():
            # at most 400 launches a round, well inside the launch queue
            n_plain = launches_per_call(lambda: synth_constant_modes_plain(f, d, a, T, SR))
            n_plain_bwd = launches_per_call(
                lambda: synth_constant_modes_bwd_plain(f, d, a, w, T, SR))
            fwd = timed(lambda: synth_kernel.synth_kernel(f, d, a, T, SR), 200)
            fwd_plain = timed(lambda: synth_constant_modes_plain(f, d, a, T, SR),
                              max(1, 400 // n_plain))
            bwd = timed(lambda: synth_kernel.synth_kernel_bwd(f, d, a, w, T, SR), 200)
            bwd_plain = timed(lambda: synth_constant_modes_bwd_plain(f, d, a, w, T, SR),
                              max(1, 400 // n_plain_bwd))
        n_fn, n_auto = launches_per_call(synthfn_step), launches_per_call(plain_step)
        fn = timed(synthfn_step, max(1, 400 // n_fn))
        auto = timed(plain_step, max(1, 400 // n_auto))
        fwd_bound, fwd_by = synth_bound(A, M, T)
        bwd_bound, bwd_by = synth_bound(A, M, T, backward=True)
        log(f"kernel synth {shape}: max|kernel-plain| {fwd_err:.3e} "
            f"(bound {float(bound.min()):.3e})")
        log(f"kernel synth {shape}: device ms per call, kernel {fmt(fwd['all'])}, "
            f"plain {fmt(fwd_plain['all'])} (three rounds; the plain version launches "
            f"{n_plain} kernels a call); host ms per call, kernel wrapper "
            f"{fwd['host_ms']:.5f}, plain {fwd_plain['host_ms']:.5f}; "
            f"bound {fwd_bound:.7f} ms ({fwd_by})")
        log(f"kernel synth_bwd {shape}: relative error (f, d, amp) against f64 "
            f"{' '.join(f'{x:.3e}' for x in bwd_rel)}, max abs {bwd_abs:.3e}; plain f32 "
            f"{' '.join(f'{x:.3e}' for x in plain_rel)}")
        log(f"kernel synth_bwd {shape}: device ms per call, kernel {fmt(bwd['all'])}, "
            f"plain {fmt(bwd_plain['all'])} (the plain backward launches {n_plain_bwd} "
            f"kernels a call); host ms per call, kernel wrapper {bwd['host_ms']:.5f}, "
            f"plain {bwd_plain['host_ms']:.5f}; bound {bwd_bound:.7f} ms ({bwd_by})")
        log(f"SynthFn forward+backward {shape}: device ms per call {fmt(fn['all'])}, "
            f"host {fn['host_ms']:.5f}, {n_fn} launches a call; autograd of the plain "
            f"version {fmt(auto['all'])}, host {auto['host_ms']:.5f}, {n_auto} launches")
        if flagship is None:
            flagship = {
                "synth_constant_modes": dict(
                    max_abs_err=fwd_err, ms=fwd["ms"], plain_ms=fwd_plain["ms"],
                    bound_ms=fwd_bound, bound_by=fwd_by),
                "synth_constant_modes_bwd": dict(
                    max_abs_err=bwd_abs, max_rel_err=max(bwd_rel), ms=bwd["ms"],
                    plain_ms=bwd_plain["ms"], bound_ms=bwd_bound, bound_by=bwd_by),
            }
    log("kernel synth, synth_bwd: no single PyTorch call computes this sum of damped "
        "sinusoids or its gradient, so there is no library time (library_ms null)")
    return flagship


MAT = (2700, 7.2e10, 0.19, 6, 1e-7)
# The JAX package's own float32-against-float64 gap for one geomloss step at
# the flagship width on the CPU, at each seed: (relative loss gap, relative
# error of the frequency gradient), as tests/test_torch_geomloss_f32.py reads
# them.  The card's float32 step at a seed is held to GEOMLOSS_MARGIN times
# the larger of JAX's gap at that seed and JAX's median over the ten: a
# seed's gap is a draw of the signal's float32 rounding, and JAX's loss gap
# at seed 13 fell 60 times below its median.  The port's float32 on the CPU
# reads 0.84-2.22 times JAX's loss gap and 0.38-3.11 times its gradient
# error at the same seeds.
GEOMLOSS_SEEDS = tuple(range(11, 21))
JAX_GEOMLOSS_F32_GAP = {
    11: (5.281e-05, 6.235e-04), 12: (3.988e-05, 1.285e-03), 13: (4.275e-07, 1.496e-03),
    14: (9.995e-05, 3.895e-04), 15: (3.585e-05, 1.132e-03), 16: (1.624e-05, 4.302e-03),
    17: (1.447e-05, 5.513e-04), 18: (2.405e-06, 8.995e-04), 19: (2.157e-05, 4.170e-04),
    20: (3.047e-05, 6.958e-04),
}
GEOMLOSS_MARGIN = 4.0


def geomloss_gate(seed=None):
    """(loss gap, gradient error) the card's f32 geomloss step is held to:
    GEOMLOSS_MARGIN times the larger of JAX's gap at `seed` and JAX's
    median; at a step with no JAX reading (seed None), JAX's worst."""
    import statistics

    cols = list(zip(*JAX_GEOMLOSS_F32_GAP.values()))
    if seed is None:
        return tuple(max(c) for c in cols)
    return tuple(GEOMLOSS_MARGIN * max(g, statistics.median(c))
                 for g, c in zip(JAX_GEOMLOSS_F32_GAP[seed], cols))
# The linear-spectrum Sinkhorn divergence alone in f32 against f64 on the
# same f32 points (lin_clouds): the JAX package's gap at each seed and n_fft,
# from `JAX_PLATFORMS=cpu python -m scripts.sinkhorn_f32_gaps`.  A seed's gap
# is one draw of float32's rounding of potentials near 3e5 (an ulp is 0.03)
# against a divergence of 10-60: JAX's spans 8e-8 to 6.7e-6 over the ten
# seeds.  The card's f32 at a seed is held to GEOMLOSS_MARGIN times the
# larger of JAX's gap there and JAX's median, as the geomloss step is.  With
# its exp-sums in float32 the port read 3.96e-6 / 3.03e-6 at seed 11, above
# that gate (2.71e-6 / 2.44e-6); summed in float64, 1.88e-6 / 1.53e-6.
JAX_SINKHORN_F32_GAP = {
    2048: {11: 2.023e-07, 12: 6.677e-06, 13: 7.965e-08, 14: 6.469e-06, 15: 3.264e-07,
           16: 5.947e-07, 17: 7.614e-07, 18: 1.896e-06, 19: 1.412e-07, 20: 4.778e-06},
    1024: {11: 3.534e-08, 12: 9.244e-07, 13: 2.286e-07, 14: 9.753e-08, 15: 2.964e-07,
           16: 1.027e-06, 17: 1.076e-06, 18: 1.362e-07, 19: 2.807e-06, 20: 2.667e-06},
}


def sinkhorn_f32_gate(n_fft, seed, jax_gaps=None):
    """The f32 Sinkhorn divergence's gate at (n_fft, seed): GEOMLOSS_MARGIN
    times the larger of JAX's gap at the seed and JAX's median over the
    seeds (`jax_gaps`, by default JAX_SINKHORN_F32_GAP[n_fft])."""
    import statistics

    gaps = JAX_SINKHORN_F32_GAP[n_fft] if jax_gaps is None else jax_gaps
    return GEOMLOSS_MARGIN * max(gaps[seed], statistics.median(gaps.values()))
# The JAX package's modal-Newton fit (E, nu) of flagship pair 0 on
# cube_tet_mesh(9, 0.3) at order 2 (20,577 DOF), float32, from
# `python -m scripts.jax_newton_reference --n 9 --pair 0`.  It misses the
# target (E 1.7256e10, nu 0.3252): on this cube's repeated modes the scale
# candidate c = 0.142 converges to a wrong fixed point whose match weight
# (2.75) beats the right candidate's (c = 0.176: E 1.726e10, nu 0.3252,
# match weight 2.67) in every extraction window.  The port's fit is held to
# it on this very mesh, in the main path and the epoch recipes; the two
# fixed points lie 20% apart in E and 0.29 in nu, ten times the gate.
JAX_NEWTON_PAIR0 = (13706449104.670244, 0.03435030386545765)

# material_real: the synthetic recordings' material, and the in-repo
# stage-1 fit of the real bowl whose damping curve damps their modes
REAL_TARGET = (2700, 5.6e10, 0.27, 6, 1e-7)
# The 16 undamped frequencies (Hz) of cube_tet_mesh(9, 0.3) at order 2 in
# REAL_TARGET: the JAX package's ground truth (host ARPACK in float64,
# scripts/jax_material_real_reference.py); the port's own solve reads the
# same to 0.1 Hz, and taking them as data saves a 17-22 s cold solve here.
REAL_GT_FREQS = (
    4330.943467022888,
    4330.943467022887,
    5818.931343973218,
    5819.75220768842,
    5819.752207688422,
    5926.79152784894,
    5926.79152784894,
    5926.793560499215,
    6736.02505627767,
    6736.025056277672,
    6738.996777140218,
    6813.7163092677265,
    6813.716309267726,
    6815.146044813604,
    7208.170762048115,
    7208.170762048116,
)
R2_STAGE1_FIT = os.path.join("results", "r2", "material_real_stage1_fit.npz")


def r2_curve_data():
    """The (freqs, damps) of the bowl's stage-1 fit, 256 pairs, float64."""
    import numpy as np

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), R2_STAGE1_FIT))
    return d["freqs"].astype(np.float64), d["damps"].astype(np.float64)


def synthetic_recordings(f_und, damps, mics: int = 8, T: int = 8000, seed: int = 0,
                         noise_db: float = -40.0):
    """Recordings of modes at undamped frequencies f_und (M,) with damping
    damps (M,), in numpy float64: per-mic amplitudes U[0.2, 1), the closed
    form sum_m amp e^{-d (n+1)/sr} sin(2 pi fd (n+1)/sr) at the damped
    frequency fd, white noise noise_db below each mic's RMS (a 40 dB
    signal-to-noise ratio by default), then each mic divided by its max |x|
    as the recordings' loader does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f_und, damps = np.asarray(f_und, np.float64), np.asarray(damps, np.float64)
    amps = rng.uniform(0.2, 1.0, (mics, len(f_und)))
    fd = np.sqrt(np.maximum((2 * np.pi * f_und) ** 2 - damps**2, 0.0)) / (2 * np.pi)
    t = (np.arange(T) + 1.0) / SR
    x = amps @ (np.exp(-damps[:, None] * t) * np.sin(2 * np.pi * fd[:, None] * t))
    rms = np.sqrt((x**2).mean(axis=1, keepdims=True))
    x = x + 10.0 ** (noise_db / 20.0) * rms * rng.standard_normal((mics, T))
    return x / (np.abs(x).max(axis=1, keepdims=True) + 1e-12)


def zero_counts():
    from diffsound_torch.audio import synth_kernel

    synth_kernel.LAUNCHES = synth_kernel.LAUNCHES_BWD = 0


def read_counts():
    from diffsound_torch.audio import synth_kernel

    return {"synth_constant_modes": synth_kernel.LAUNCHES,
            "synth_constant_modes_bwd": synth_kernel.LAUNCHES_BWD}


def check_losses(name, losses, n, early=None):
    """Finite, n of them, and falling: the mean of the last 15 below the
    first 15's (a third of the epochs where fewer than 45), over the early
    phase's first `early` epochs when given, else over the whole run."""
    import numpy as np

    if not (len(losses) == n and np.isfinite(losses).all()):
        raise RuntimeError(f"{name}: non-finite or missing losses")
    part = losses[:early] if early else losses
    k = min(15, len(part) // 3)
    if not part[-k:].mean() < part[:k].mean():
        raise RuntimeError(f"{name}: the {'early phase' if early else 'run'}'s loss did not "
                           f"fall: first {k} mean {part[:k].mean():.6g}, last {k} mean "
                           f"{part[-k:].mean():.6g}")


def check_newton(label, res, gt_mat):
    """The modal-Newton fit within 2% in E and 0.03 in nu (the bounds of
    tests/test_modal_fit.py) of the JAX package's fit of the same pair on
    the cube, JAX_NEWTON_PAIR0; its distance to the target is printed."""
    e_jax, nu_jax = JAX_NEWTON_PAIR0
    e_err, nu_err = abs(res["newton_E"] / e_jax - 1), abs(res["newton_nu"] - nu_jax)
    log(f"{label}: Newton fit against the JAX package's (E {e_jax:.6g}, nu {nu_jax:.5f}): "
        f"E off by {e_err:.3e} relative, nu by {nu_err:.3e}; against the target: E by "
        f"{abs(res['newton_E'] / gt_mat[1] - 1):.3e}, nu by "
        f"{abs(res['newton_nu'] - gt_mat[2]):.3e}")
    if not (e_err <= 0.02 and nu_err <= 0.03):
        raise RuntimeError(f"{label}: the Newton fit disagrees with the JAX package's: E by "
                           f"{e_err:.3e} (gate 0.02), nu by {nu_err:.3e} (gate 0.03)")


def main_path_phase():
    """The material_sync `newton` recipe at full width: ground truth, the
    modal-Newton fit over three extraction windows, and the 300-epoch polish
    (L1 + 300 x freq-chamfer).  Returns the kernels' launch counts and the
    ground truth (the epoch recipes run on the same mesh and pair)."""
    import numpy as np
    import torch

    from diffsound_torch.experiments.material_sync import (
        MaterialSyncTask, flagship_material_pairs,
    )
    from diffsound_torch.fem.mesh import cube_tet_mesh
    from diffsound_torch.models.sound_obj import build_model

    mesh = cube_tet_mesh(9, 0.3)
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    task = MaterialSyncTask(mesh=mesh, mode_num=16, sample_rate=SR, frame_num=8000,
                            force_frame_num=150, exp_mode=3)
    polish = 300

    zero_counts()
    t0 = time.perf_counter()
    gt_audio, _ = task.make_gt(gt_mat)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    res = task.train_newton(init_mat, gt_audio, rounds=20, polish_epochs=polish,
                            verbose=False)
    torch.cuda.synchronize()
    launches = read_counts()

    eig, fit = res["eig"], res["fit"]
    dof = eig.eigenvectors.shape[0]
    warm = [s for s in fit["solves"] if s["warm"]]
    cold = [s for s in fit["solves"] if not s["warm"]]
    log(f"main path: {dof} DOF, ground truth (order-2 model + ARPACK + synth) {gt_s:.3f} s")
    log(f"main path: modal-Newton fit {fit['wall_s']:.3f} s: {len(cold)} cold solve(s) "
        f"({fmt(s['seconds'] for s in cold)} s), {len(warm)} warm solves, "
        f"mean {1e3 * np.mean([s['seconds'] for s in warm]):.2f} ms each with the modal "
        f"cache and host pull; LOBPCG iterations per warm solve "
        f"{[s['iterations'] for s in warm]}")
    for w in fit["windows"]:
        log(f"main path: window {w['window']}@{w['n_fft']}: E {w['E']:.6g} nu {w['nu']:.5f}, "
            f"union coverage {w['score']:.5f}, {w['rounds']} rounds in its chosen candidate")
    log(f"main path: chosen fit E {res['newton_E']:.6g} nu {res['newton_nu']:.5f}; the "
        f"target E {gt_mat[1]:.6g} nu {gt_mat[2]:.5f}, init E {init_mat[1]:.6g} nu "
        f"{init_mat[2]:.5f}")
    check_newton("main path", res, gt_mat)
    losses = res["losses"]
    refresh_s, iters = np.asarray(res["refresh_s"]), np.asarray(res["refresh_iters"])
    log(f"main path: polish cold ARPACK solve + modal cache {res['cold_s'][0]:.3f} s; "
        f"{len(refresh_s)} warm refreshes, mean {1e3 * refresh_s.mean():.2f} ms, LOBPCG "
        f"iterations {iters.tolist()}")
    log(f"main path: polish {polish} steps, mean step {1e3 * res['step_s'] / polish:.3f} ms; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; E {res['youngs']:.6g} nu "
        f"{res['poisson']:.5f}; recipe wall {res['wall_s']:.3f} s")
    log(f"main path: synth kernel launches {launches['synth_constant_modes']}, "
        f"synth backward kernel launches {launches['synth_constant_modes_bwd']}")

    if dof != 20577:
        raise RuntimeError(f"expected 20,577 DOF, got {dof}")
    check_losses("main path polish", losses, polish)
    for name, n in launches.items():
        if n < polish:
            raise RuntimeError(f"the main path launched {name} {n} times, fewer than "
                               f"its {polish} polish steps")

    # A warm refresh against host ARPACK at the same material: from the last
    # refresh's eigenvectors back to the material of the polish's cold
    # ARPACK solve (a fresh ARPACK solve at the last refresh's material
    # would cost another cold solve of the script's time limit)
    mu, lam = res["cold_lame"][-1]
    check = build_model(mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material")
    t0 = time.perf_counter()
    again = check.eigen_decomposition_at_lame(mu, lam, prev=eig)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    got = again.eigenvalues[6:].double().cpu().numpy()
    want = res["cold_eig"].eigenvalues[6:].double().cpu().numpy()
    rel = float(np.abs(got / want - 1.0).max())
    log(f"main path: warm refresh from the last refresh's eigenvectors to the polish's "
        f"start ({again.iterations} LOBPCG iterations, {1e3 * warm_s:.2f} ms) vs its host "
        f"ARPACK solve: max relative eigenvalue error {rel:.3e} over 16 modes")
    if not rel <= 1e-3:
        raise RuntimeError(f"refresh eigenvalues off ARPACK by {rel:.3e} (> 1e-3)")

    # the polish's loss at the pair's pretrained start, far from the target
    # (where the adam recipe begins): near the fit the polish's L1 gradient
    # is below f32's rounding of it on any device (its sign flips on the CPU)
    step_precision_check(check, mesh, init_mat, eig, check.init_params(0), gt_audio)
    cache = check.modal_cache(eig)
    for chamfer in (False, True):
        step_profile(check, cache, res["params"], gt_audio, init_mat, chamfer)
    return launches, gt_audio


def step_inputs(init_mat, gt_audio, dtype):
    """The trainer's oscillator bank, impulse force, 5-scale L1 loss and
    target cache, and the polish's freq-chamfer peaks, at the main path's
    width."""
    from diffsound_torch.audio.freq_loss import extract_spectral_peaks
    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material

    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(init_mat))
    forces = impulse_forces(1, 150, dtype, gt_audio.device)
    loss_fn = MSSLoss([1024, 512, 256, 128, 64], SR, loss_type="l1_loss")
    peaks = extract_spectral_peaks(gt_audio.cpu().numpy(), SR)
    return osc, forces, loss_fn, loss_fn.target_cache(gt_audio.to(dtype)), peaks


def polish_loss(model, params, cache, osc, forces, loss_fn, tc, peaks, dtype, chamfer=True):
    """The polish step's loss: 5-scale L1, plus 300 x freq-chamfer."""
    from diffsound_torch.audio.freq_loss import freq_chamfer_loss

    freqs = model.get_undamped_freqs_cached(params, cache)
    sig, damped = osc(freqs, forces, dtype=dtype)
    loss = loss_fn(sig, None, damped, 1.0, target_cache=tc)
    if chamfer:
        loss = loss + 300.0 * freq_chamfer_loss(freqs, *peaks, SR)
    return freqs, sig, loss


STEP_GATES = dict(freqs=1e-4, loss=3e-5, cos=0.999, step=1e-3, grad=0.5, probe=0.5)


def step_precision_check(model, mesh, init_mat, eig, params, gt_audio):
    """One cached polish step on the card in f32 (bmm modal cache,
    synthesis kernel, cuFFT loss, freq-chamfer, autograd, Adam) against the
    port's f64 on the CPU, at the same params and the same eigenvectors.

    Gates, the card's f32 against the f64: corrected frequencies within
    1e-4 relative; the loss within 3e-5 relative (the frequencies' f32
    error reaches the loss one to one through the 300 x chamfer term: both
    read 1.3e-5 to 1.5e-5 at the pretrained start, on the card and in the
    CPU's f32 alike); each tensor of the loss's gradient at cosine >= 0.999;
    one Adam step from a fresh state moves every parameter within 1e-3 lr
    of the f64 step; the relative norm errors of the loss's gradient and of
    a smooth probe's, <signal, target>, under 0.5, which catches a wrong
    sign or factor (in f32 they are loose on any device: the gradient sums
    8000 samples of oscillating terms that mostly cancel, and the
    log-spectrogram passes through d log(S)/dS = 1/S for every bin; Adam
    divides each parameter's step by its own gradient scale, so the step
    does not see it)."""
    import torch

    from diffsound_torch.experiments.material_sync import adam_step_decay
    from diffsound_torch.models.sound_obj import EigenState, build_model

    lr = 2e-3
    host = build_model(mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material",
                       dtype=torch.float64, device="cpu")
    models = {"card f32": (model, model.device, torch.float32),
              "cpu f64": (host, torch.device("cpu"), torch.float64)}
    runs = {}
    for name, (m, device, dtype) in models.items():
        e = EigenState(*(t.to(device=device, dtype=dtype) for t in
                         (eig.eigenvalues, eig.eigenvectors)), eig.iterations,
                       eig.residual.to(device=device, dtype=dtype))
        p = {k: v.detach().to(device).clone().requires_grad_(True)
             for k, v in params.items()}
        keys = list(p)
        osc, forces, loss_fn, tc, peaks = step_inputs(init_mat, gt_audio.to(device), dtype)
        freqs, sig, loss = polish_loss(m, p, m.modal_cache(e), osc, forces, loss_fn, tc,
                                       peaks, dtype)
        probe = (sig * gt_audio.to(device=device, dtype=dtype)).sum()
        g_probe = torch.autograd.grad(probe, [p[k] for k in keys], retain_graph=True)
        loss.backward()
        grads = [p[k].grad.detach().clone() for k in keys]
        m.bins.mask_grads(p)
        before = [p[k].detach().clone() for k in keys]
        opt, _ = adam_step_decay([p[k] for k in keys], lr, 0.95)
        opt.step()
        steps = [p[k].detach() - b for k, b in zip(keys, before)]
        cpu = lambda ts: [t.double().cpu() for t in ts]
        runs[name] = dict(freqs=freqs.detach().double().cpu(), loss=loss.item(),
                          probe=cpu(g_probe), grad=cpu(grads), step=cpu(steps))

    def rel(a, b):
        return max(float((x - y).norm() / y.norm()) for x, y in zip(a, b))

    ref, card = runs["cpu f64"], runs["card f32"]
    x = dict(
        freqs=float(((card["freqs"] - ref["freqs"]).abs() / ref["freqs"]).max()),
        loss=abs(card["loss"] / ref["loss"] - 1),
        probe=rel(card["probe"], ref["probe"]),
        grad=rel(card["grad"], ref["grad"]),
        cos=min(float((a * b).sum() / (a.norm() * b.norm()))
                for a, b in zip(card["grad"], ref["grad"])),
        step=max(float((a - b).abs().max())
                 for a, b in zip(card["step"], ref["step"])) / lr,
    )
    log(f"step precision (polish loss) at the pretrained start, card f32 against cpu f64: "
        f"frequencies {x['freqs']:.3e}, loss {card['loss']:.6f} vs {ref['loss']:.6f} "
        f"({x['loss']:.3e}), loss gradient {x['grad']:.3e} in relative norm at "
        f"cosine {x['cos']:.9f}, probe gradient {x['probe']:.3e}, Adam step "
        f"{x['step']:.3e} lr")
    if not (x["cos"] >= STEP_GATES["cos"] and all(
            x[k] <= v for k, v in STEP_GATES.items() if k != "cos")):
        raise RuntimeError("the f32 cached step on the card disagrees with the CPU f64 "
                           "step beyond its gates (see the docstring of step_precision_check)")


def profile_step(label, step, steps: int = 30, profiled: int = 5, kernels=()):
    """Where a step's time goes: the host's wall time per step, and from
    torch.profiler the kernels launched per step and the device time they
    take, with the device ms of each kernel named in `kernels`.  Returns
    (host ms, device ms, cudaLaunchKernel calls) per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    device_work = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device_work) / profiled
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel") / profiled
    kernels_n = sum(1 for e in device_work
                    if not e.name.startswith(("Memcpy", "Memset"))) / profiled
    log(f"{label}: host {host_ms:.3f} ms per step, device work {device_ms:.3f} ms "
        f"(idle share {1 - device_ms / host_ms:.3f}), {launches:.0f} cudaLaunchKernel "
        f"calls, {kernels_n:.0f} kernels and {len(device_work) / profiled:.0f} device "
        f"activities per step")
    for name in kernels:
        ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device_work if name in e.name)
        n = sum(1 for e in device_work if name in e.name)
        log(f"{label}: {name} {ms / profiled:.5f} ms per step in {n / profiled:.0f} "
            f"launches, {ms / profiled / device_ms:.4f} of the device work")
    if not 0 < device_ms < host_ms:
        raise RuntimeError(f"{label}: device work {device_ms:.3f} ms per step "
                           f"against {host_ms:.3f} ms of host time")
    return host_ms, device_ms, launches


def step_profile(model, cache, params, gt_audio, init_mat, chamfer):
    """The cached training step at the main path's width: cached
    frequencies, synthesis, force convolution, 5-scale L1 (plus the
    polish's 300 x freq-chamfer when `chamfer`), backward, Adam."""
    import torch

    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    osc, forces, loss_fn, tc, peaks = step_inputs(init_mat, gt_audio, torch.float32)
    opt = torch.optim.Adam(list(params.values()), lr=2e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        polish_loss(model, params, cache, osc, forces, loss_fn, tc, peaks, torch.float32,
                    chamfer)[2].backward()
        model.bins.mask_grads(params)
        opt.step()

    profile_step("step profile, " + ("polish (L1 + 300 x chamfer)" if chamfer
                                     else "L1-only"), step)


def geomloss_step(model, eig, params, target, init_mat, device, dtype):
    """One geomloss step (MSSLoss([2048, 1024]) on the cached frequencies'
    synthesis) on `device` in `dtype`: (loss, gradient to the undamped
    frequencies, gradients to the params)."""
    import torch

    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material
    from diffsound_torch.models.sound_obj import EigenState

    e = EigenState(*(t.to(device=device, dtype=dtype) for t in
                     (eig.eigenvalues, eig.eigenvectors)), eig.iterations,
                   eig.residual.to(device=device, dtype=dtype))
    p = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in params.items()}
    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(init_mat))
    forces = impulse_forces(1, 150, dtype, device)
    loss_fn = MSSLoss([2048, 1024], SR, loss_type="geomloss")
    tc = loss_fn.target_cache(target.to(device=device, dtype=dtype))
    freqs = model.get_undamped_freqs_cached(p, model.modal_cache(e))
    freqs.retain_grad()
    sig, damped = osc(freqs, forces, dtype=dtype)
    loss = loss_fn(sig, None, damped, 1.0, target_cache=tc)
    loss.backward()
    return (loss.item(), freqs.grad.double().cpu(),
            [p[k].grad.double().cpu() for k in sorted(p)])


def geomloss_standin(seed, device, dtype):
    """tests/test_torch_geomloss_f32.py's geomloss step at `seed`: a target from
    16 seeded modes, a prediction 5% above it; (loss, gradient to the
    predicted undamped frequencies)."""
    import numpy as np
    import torch

    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.fem.material import Material

    rng = np.random.default_rng(seed)
    f_tgt = np.sort(rng.uniform(400, 14000, 16))
    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(MAT))
    forces = torch.zeros((1, 150), dtype=dtype, device=device)
    forces[0, 0] = 1.0
    target, _ = osc(torch.as_tensor(f_tgt, dtype=dtype, device=device), forces, dtype=dtype)
    loss_fn = MSSLoss([2048, 1024], SR, loss_type="geomloss")
    fp = torch.as_tensor(1.05 * f_tgt, dtype=dtype, device=device).requires_grad_(True)
    sig, damped = osc(fp, forces, dtype=dtype)
    loss = loss_fn(sig, None, damped, 1.0, target_cache=loss_fn.target_cache(target))
    (g,) = torch.autograd.grad(loss, fp)
    return loss.item(), g.double().cpu()


def lin_clouds(seed, n_fft):
    """geomloss_standin's prediction and target at `seed` as the geomloss
    linear-spectrum point clouds at n_fft, made in f64 on the CPU and
    rounded to f32 once: (x, y), each (1, n_fft // 2 + 1, 4)."""
    import numpy as np
    import torch

    from diffsound_torch.audio.mss_loss import spec_to_points
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.audio.stft import spectrogram
    from diffsound_torch.fem.material import Material

    f_tgt = np.sort(np.random.default_rng(seed).uniform(400, 14000, 16))
    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(MAT))
    forces = torch.zeros((1, 150), dtype=torch.float64)
    forces[0, 0] = 1.0
    clouds = []
    for f, moved in ((1.05 * f_tgt, True), (f_tgt, False)):
        sig, damped = osc(torch.as_tensor(f), forces, dtype=torch.float64)
        spec = spectrogram(sig / sig.abs().max(), n_fft, n_fft // 4)
        clouds.append(spec_to_points(spec, damped if moved else None, SR).float())
    return clouds


def geomloss_gap(label, card, cpu, gate):
    """The card's f32 geomloss step against the port's f64 on the CPU: the
    loss's relative gap and the frequency gradient's relative error, held
    to gate = (loss gap, gradient error)."""
    gap = abs(card[0] / cpu[0] - 1)
    err = float((card[1] - cpu[1]).norm() / cpu[1].norm())
    log(f"geomloss precision, {label}: card f32 loss {card[0]!r} vs cpu f64 {cpu[0]!r}, "
        f"relative gap {gap:.3e} (gate {gate[0]:.3e}); frequency gradient relative error "
        f"{err:.3e} (gate {gate[1]:.3e})")
    if not (gap <= gate[0] and err <= gate[1]):
        raise RuntimeError(f"geomloss precision, {label}: the card's f32 step is further "
                           f"from f64 than its gate")


def sinkhorn_check(device):
    """The linear-spectrum Sinkhorn divergence alone, in f32 on the card
    against f64 on the same f32 points (also on the card; the CPU's f64
    reads the same to 1e-13), at every seed and both n_fft: the
    f32 arithmetic of the loss without the signal's rounding, which
    dominates the whole geomloss step's gap (sinkhorn_f32_gate)."""
    import torch

    from diffsound_torch.audio.sinkhorn import sinkhorn_divergence

    for n_fft in (2048, 1024):
        for seed in GEOMLOSS_SEEDS:
            x, y = lin_clouds(seed, n_fft)
            x, y = x.to(device), y.to(device)
            v32 = sinkhorn_divergence(x, y).item()
            v64 = sinkhorn_divergence(x.double(), y.double()).item()
            gap, gate = abs(v32 / v64 - 1), sinkhorn_f32_gate(n_fft, seed)
            log(f"Sinkhorn divergence alone at n_fft {n_fft}, seed {seed}: card f32 {v32!r} "
                f"vs card f64 {v64!r}, relative gap {gap:.3e} (gate {gate:.3e}; JAX "
                f"{JAX_SINKHORN_F32_GAP[n_fft][seed]:.3e})")
            if not gap <= gate:
                raise RuntimeError(f"Sinkhorn divergence at n_fft {n_fft}, seed {seed}: the "
                                   f"card's f32 is {gap:.3e} from f64")


def reference_phase(gt_audio=None):
    """The epoch recipes at full audio width on cube_tet_mesh(9, 0.3) at
    order 2 (20,577 DOF), from the main path's ground truth when given: the
    reference recipe (45 geomloss epochs across three refreshes, then 15 L1
    epochs) and the default epoch recipe (15 freq-chamfer epochs, then 15 of
    L1 + 300 x chamfer).  Then the geomloss step on the card in f32 against
    the port's f64 on the CPU, at the reference run's params and
    eigenvectors and at the ten seeded steps of
    tests/test_torch_geomloss_f32.py, and a profile of the geomloss step.
    (The modal-Newton fit on this mesh is the main path's.)"""
    import numpy as np
    import torch

    from diffsound_torch.experiments.material_sync import (
        MaterialSyncTask, flagship_material_pairs,
    )
    from diffsound_torch.fem.mesh import cube_tet_mesh
    from diffsound_torch.models.sound_obj import build_model

    mesh = cube_tet_mesh(9, 0.3)
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    task = MaterialSyncTask(mesh=mesh, mode_num=16, sample_rate=SR, frame_num=8000,
                            force_frame_num=150, exp_mode=3)
    if gt_audio is None:
        t0 = time.perf_counter()
        gt_audio, _ = task.make_gt(gt_mat)
        torch.cuda.synchronize()
        log(f"epoch recipes: ground truth at 20,577 DOF {time.perf_counter() - t0:.3f} s")
    runs = {}
    for name, kw in (("reference", dict(max_epoch=60, early_loss_epoch=45,
                                        early_loss_type="geomloss", late_freq_weight=0.0)),
                     ("default", dict(max_epoch=30, early_loss_epoch=15,
                                      early_loss_type="freq_chamfer", late_freq_weight=300.0))):
        zero_counts()
        res = task.train(init_mat, gt_audio, pretrain=True, verbose=False, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        losses, early = res["losses"], kw["early_loss_epoch"]
        dof = res["eig"].eigenvectors.shape[0]
        log(f"{name} recipe: {dof} DOF, cold solve {res['cold_s'][0]:.3f} s, "
            f"{len(res['refresh_s'])} refreshes (LOBPCG iterations {res['refresh_iters']}), "
            f"{kw['max_epoch']} steps in {res['step_s']:.3f} s, wall {res['wall_s']:.3f} s")
        log(f"{name} recipe: early loss {losses[0]:.6g} -> {losses[early - 1]:.6g}, late loss "
            f"{losses[early]:.6g} -> {losses[-1]:.6g}; E {res['youngs']:.6g} nu "
            f"{res['poisson']:.5f} (target {gt_mat[1]:.6g}, {gt_mat[2]:.5f}; init "
            f"{init_mat[1]:.6g}, {init_mat[2]:.5f}); synth launches {counts}")
        if dof != 20577:
            raise RuntimeError(f"expected 20,577 DOF, got {dof}")
        check_losses(f"{name} recipe", losses, kw["max_epoch"], early=early)
        if counts["synth_constant_modes"] < kw["max_epoch"] - early or \
                counts["synth_constant_modes_bwd"] < kw["max_epoch"] - early:
            raise RuntimeError(f"{name} recipe: synth kernels launched {counts}")
        runs[name] = res

    res = runs["reference"]
    model = build_model(mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material")
    host = build_model(mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material",
                       dtype=torch.float64, device="cpu")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = geomloss_step(model, res["eig"], res["params"], gt_audio, init_mat,
                         model.device, torch.float32)
    peak = torch.cuda.max_memory_allocated() - base
    cpu = geomloss_step(host, res["eig"], res["params"], gt_audio.cpu(), init_mat,
                        torch.device("cpu"), torch.float64)
    log(f"geomloss step on the card: peak memory {peak / 2**30:.3f} GiB above "
        f"{base / 2**30:.3f} GiB already allocated")
    cos_p = min(float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(card[2], cpu[2]))
    with torch.no_grad():
        freqs = model.get_undamped_freqs_cached(res["params"], model.modal_cache(res["eig"]))
    log(f"geomloss precision, reference run's params: parameter gradient cosine {cos_p:.9f}; "
        f"the step's undamped frequencies {fmt(freqs.tolist(), 3)} Hz")
    sinkhorn_check(model.device)
    geomloss_gap("reference run's params and eigenvectors", card, cpu, geomloss_gate())
    for seed in GEOMLOSS_SEEDS:
        geomloss_gap(f"seeded step {seed}", geomloss_standin(seed, model.device, torch.float32),
                     geomloss_standin(seed, torch.device("cpu"), torch.float64),
                     geomloss_gate(seed))

    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material

    params = {k: v.detach().clone().requires_grad_(True) for k, v in res["params"].items()}
    cache = model.modal_cache(res["eig"])
    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(init_mat))
    forces = impulse_forces(1, 150, torch.float32, model.device)
    loss_fn = MSSLoss([2048, 1024], SR, loss_type="geomloss")
    tc = loss_fn.target_cache(gt_audio)
    opt = torch.optim.Adam(list(params.values()), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        sig, damped = osc(model.get_undamped_freqs_cached(params, cache), forces)
        loss_fn(sig, None, damped, 1.0, target_cache=tc).backward()
        model.bins.mask_grads(params)
        opt.step()

    profile_step("step profile, geomloss", step, steps=5, profiled=2)
    if not np.isfinite(card[0]):
        raise RuntimeError("geomloss step: non-finite loss on the card")


# material_real: stage 1's Adam steps (the config's 2001), stage 2's
# epochs (the config's 1000 geomloss + 2000 L1 cut to three refreshes of
# geomloss and two of L1), the chained run's, and the CLI's stage-1 steps
REAL_STAGE1_ITERS = 2001
REAL_STAGE2_EPOCHS = (45, 30)
REAL_CHAINED_EPOCHS = (15, 15)
REAL_CLI = dict(gt_iters=100, max_epoch=20, early_loss_epoch=10)
# The JAX package on the same recordings (`python -m
# scripts.jax_material_real_reference --iters 300`, CPU): stage 2's
# modal-Newton start from MatSet.Ceramic with the r2 curve on
# cube_tet_mesh(9, 0.3) at order 2 (float64), and stage 1's loss (float32,
# its own seeded draw and noise) at its start and after 300 steps.
JAX_REAL_NEWTON = (55383857046.05093, 0.253859619848809)
JAX_STAGE1_FALL = (300, 40.35353469848633, 25.616779327392578)
# One stage-1 step in f32 on the card against the port's f64 on the CPU at
# the same params and noise: the loss's relative gap and each gradient's
# cosine (the port's f32 on the CPU reads 2.0e-6 and 0.9999976 at this step).
STAGE1_GATES = dict(loss=2e-5, cos=0.9999)


def real_recordings():
    """The material_real phase's 8-mic recordings (8, 8000), float64 numpy,
    of REAL_GT_FREQS damped by the r2 curve, and the curve."""
    import numpy as np

    from diffsound_torch.audio.damping import DampingCurve

    curve = DampingCurve(*r2_curve_data())
    f_und = np.asarray(REAL_GT_FREQS)
    log(f"material_real: recordings of {fmt(f_und, 1)} Hz, curve damping "
        f"{fmt(curve(f_und), 2)} 1/s")
    return synthetic_recordings(f_und, curve(f_und)), curve


def stage1_step(audio, params, noise, device, dtype):
    """One stage-1 loss and its gradients (GT bank, 256 modes, filtered
    noise at 2e-4, 5-scale L1) at `params` with the white noise `noise`."""
    import torch

    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import GTOscillatorBank
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material, MatSet

    bank = GTOscillatorBank(8, 256, 8000, SR, Material.of(MatSet.Ceramic))
    p = {k: v.to(device=device, dtype=dtype).requires_grad_(True) for k, v in params.items()}
    loss_fn = MSSLoss([512, 256, 128, 64, 32], SR, loss_type="l1_loss")
    sig, _ = bank(p, impulse_forces(8, 150, dtype, device), noise_rate=2e-4,
                  noise=noise.to(device=device, dtype=dtype))
    loss = loss_fn(sig, torch.as_tensor(audio, dtype=dtype, device=device))
    loss.backward()
    return loss.item(), {k: v.grad.double().cpu() for k, v in p.items()}


def stage1_precision_check(audio, device):
    """Stage 1's step in f32 on `device` against the port's f64 on the CPU,
    at the seeded start and one draw of noise."""
    import torch

    from diffsound_torch.audio.filtered_noise import FilteredNoise
    from diffsound_torch.audio.oscillator import GTOscillatorBank
    from diffsound_torch.fem.material import Material, MatSet

    gen = torch.Generator().manual_seed(0)
    params = GTOscillatorBank(8, 256, 8000, SR, Material.of(MatSet.Ceramic)).init_params(
        gen, torch.float64)
    noise = FilteredNoise(8, 8000).white_noise(gen, torch.float64)
    l32, g32 = stage1_step(audio, params, noise, device, torch.float32)
    l64, g64 = stage1_step(audio, params, noise, torch.device("cpu"), torch.float64)
    gap = abs(l32 / l64 - 1)
    cos = {k: float((g32[k] * g64[k]).sum() / (g32[k].norm() * g64[k].norm())) for k in g64}
    rel = {k: float((g32[k] - g64[k]).norm() / g64[k].norm()) for k in g64}
    log(f"stage-1 precision on {device} f32 against cpu f64: loss {l32!r} vs {l64!r}, "
        f"relative gap {gap:.3e} (gate {STAGE1_GATES['loss']:.0e}); gradient cosine "
        + ", ".join(f"{k} {cos[k]:.9f}" for k in cos) + "; relative norm error "
        + ", ".join(f"{k} {rel[k]:.3e}" for k in rel))
    return gap, cos


def check_stage2(label, res, epochs, newton_gate=True):
    """Stage 2's run: finite losses falling in each phase, a finite Newton
    start (held to the JAX package's when newton_gate), the timing logged."""
    import numpy as np

    early, late = epochs
    fit = res["newton"]
    warm = [s for s in fit["solves"] if s["warm"]]
    cold = [s for s in fit["solves"] if not s["warm"]]
    log(f"{label}: pretrain_damps {res['pretrain_damps_s']:.3f} s; Newton start "
        f"{res['newton_s']:.3f} s ({len(cold)} cold solve {fmt(s['seconds'] for s in cold)} "
        f"s, {len(warm)} warm solves, mean {1e3 * np.mean([s['seconds'] for s in warm]):.2f} "
        f"ms, LOBPCG iterations {[s['iterations'] for s in warm]}): E {fit['E']:.6g} nu "
        f"{fit['nu']:.5f} (target {REAL_TARGET[1]:.6g}, {REAL_TARGET[2]:.5f})")
    log(f"{label}: epoch-0 cold solve {fmt(res['cold_s'], 3)} s, {len(res['refresh_s'])} "
        f"refreshes {fmt(res['refresh_s'], 3)} s (LOBPCG iterations {res['refresh_iters']}); "
        f"{early} geomloss steps {res['step_s']['early']:.3f} s "
        f"({1e3 * res['step_s']['early'] / early:.1f} ms each), {late} L1 steps "
        f"{res['step_s']['late']:.3f} s; loss {res['losses'][0]:.6g} -> "
        f"{res['losses'][early - 1]:.6g} | {res['losses'][early]:.6g} -> "
        f"{res['losses'][-1]:.6g}; E {res['youngs']:.6g} nu {res['poisson']:.5f}; wall "
        f"{res['wall_s']:.3f} s")
    if not all(np.isfinite([fit["E"], fit["nu"], res["youngs"], res["poisson"]])):
        raise RuntimeError(f"{label}: non-finite E or nu")
    if newton_gate:
        check_fit(label, fit, JAX_REAL_NEWTON)
    check_losses(f"{label} geomloss phase", res["losses"][:early], early)
    check_losses(f"{label} L1 phase", res["losses"][early:], late)


def check_fit(label, fit, ref):
    """A Newton fit within 2% in E and 0.03 in nu of the JAX package's."""
    e_err, nu_err = abs(fit["E"] / ref[0] - 1), abs(fit["nu"] - ref[1])
    log(f"{label}: Newton start against the JAX package's (E {ref[0]:.6g}, nu {ref[1]:.5f}): "
        f"E off by {e_err:.3e} relative, nu by {nu_err:.3e}")
    if not (e_err <= 0.02 and nu_err <= 0.03):
        raise RuntimeError(f"{label}: the Newton start disagrees with the JAX package's: E by "
                           f"{e_err:.3e} (gate 0.02), nu by {nu_err:.3e} (gate 0.03)")


def material_real_phase():
    """The material_real task on the card: stage 1 at full width (8 mics,
    256 modes, 8000 samples, 2001 steps) on synthetic recordings of
    cube_tet_mesh(9, 0.3) at order 2; one stage-1 step in f32 against the
    CPU's f64; stage 2 from the r2 curve (Newton start, 45 geomloss and 30
    L1 epochs) against the JAX package's Newton start, with the geomloss
    and L1 steps' profiles and the geomloss step's peak memory; the chained
    run (stage 1's curve into stage 2); the CLI, fresh and from its cache.
    Returns the kernels' launch counts of stage 1 and stage 2."""
    import numpy as np
    import torch

    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import OscillatorBank
    from diffsound_torch.experiments import material_real
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material, MatSet
    from diffsound_torch.fem.mesh import cube_tet_mesh
    from diffsound_torch.models.sound_obj import build_model

    mesh = cube_tet_mesh(9, 0.3)
    audio, curve = real_recordings()
    forces = impulse_forces(8, 150)

    # stage 1 at full width
    zero_counts()
    t0 = time.perf_counter()
    bank, params, losses = material_real.fit_gt_oscillator(
        audio.astype(np.float32), forces, 256, SR, MatSet.Ceramic, iters=REAL_STAGE1_ITERS,
        verbose=False)
    torch.cuda.synchronize()
    stage1_s = time.perf_counter() - t0
    counts = {"stage 1": read_counts()}
    n_iters, jax_start, jax_end = JAX_STAGE1_FALL
    log(f"stage 1: {REAL_STAGE1_ITERS} steps in {stage1_s:.3f} s "
        f"({1e3 * stage1_s / REAL_STAGE1_ITERS:.3f} ms a step); loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g} (min {losses.min():.6g}); the JAX package's {jax_start:.6g} -> "
        f"{jax_end:.6g} in {n_iters} steps; synth launches {counts['stage 1']}")
    if not (losses.shape == (REAL_STAGE1_ITERS,) and np.isfinite(losses).all()):
        raise RuntimeError("stage 1: non-finite or missing losses")
    if not losses[-1] < jax_end:
        raise RuntimeError(f"stage 1: the loss after {REAL_STAGE1_ITERS} steps, "
                           f"{losses[-1]:.6g}, is not below the JAX package's after "
                           f"{n_iters}, {jax_end:.6g}")
    for name, n in counts["stage 1"].items():
        if n < REAL_STAGE1_ITERS:
            raise RuntimeError(f"stage 1 launched {name} {n} times, fewer than its "
                               f"{REAL_STAGE1_ITERS} steps")

    # stage 1's step: profile, kernels' share; precision against the CPU
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss_fn = MSSLoss([512, 256, 128, 64, 32], SR, loss_type="l1_loss")
    gt = torch.as_tensor(audio, dtype=torch.float32, device="cuda")
    tc = loss_fn.target_cache(gt)
    fz = forces.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    opt = torch.optim.Adam(list(p.values()), lr=5e-3)

    def s1_step():
        opt.zero_grad(set_to_none=True)
        sig, _ = bank(p, fz, noise_rate=2e-4, generator=gen)
        loss_fn(sig, None, target_cache=tc).backward()
        opt.step()

    profile_step("step profile, stage 1 (8 x 256 x 8000)", s1_step,
                 kernels=("synth_fwd_kernel", "synth_bwd_kernel"))
    gap, cos = stage1_precision_check(audio, torch.device("cuda"))
    if not (gap <= STAGE1_GATES["loss"] and min(cos.values()) >= STAGE1_GATES["cos"]):
        raise RuntimeError("stage 1: the f32 step on the card disagrees with the CPU's f64 "
                           "step beyond its gates")
    chained_curve = material_real.extract_damping_curve(bank, params)
    log(f"stage 1 -> curve: {len(chained_curve.x)} bands, damping "
        f"{fmt(chained_curve.y, 2)} 1/s")

    # stage 2 from the fixed r2 curve
    early, late = REAL_STAGE2_EPOCHS
    zero_counts()
    res = material_real.train_material_real(mesh, audio, curve, MatSet.Ceramic,
                                            max_epoch=early + late, early_loss_epoch=early,
                                            verbose=False)
    torch.cuda.synchronize()
    counts["stage 2"] = read_counts()
    log(f"stage 2: synth launches {counts['stage 2']}")
    check_stage2("stage 2 (r2 curve)", res, REAL_STAGE2_EPOCHS)
    # every step synthesizes; the geomloss gradient reaches the frequencies
    # through the point clouds' positions, not through the signal, so only
    # the L1 steps run the backward kernel
    if counts["stage 2"]["synth_constant_modes"] < early + late or \
            counts["stage 2"]["synth_constant_modes_bwd"] < late:
        raise RuntimeError(f"stage 2 launched the synth kernels {counts['stage 2']} times "
                           f"in {early} geomloss and {late} L1 steps")

    # stage 2's steps at 8 mics: geomloss peak memory and profiles
    model = build_model(mesh=mesh, mode_num=16, order=2, mat=MatSet.Ceramic, task="material")
    cache = model.modal_cache(res["eig"])
    osc = OscillatorBank(8, 16, 8000, SR, Material.of(MatSet.Ceramic))
    osc_params = osc.init_params(torch.Generator(device="cuda").manual_seed(0))
    sp = {k: v.detach().clone().requires_grad_(True) for k, v in res["params"].items()}
    with torch.no_grad():
        f_now = model.get_undamped_freqs_cached(sp, cache)
    cd = torch.as_tensor(curve(f_now.double().cpu().numpy()), dtype=torch.float32,
                         device="cuda")
    fz = impulse_forces(8, 150, torch.float32, "cuda")
    for loss_type, n_ffts in (("geomloss", [2048, 1024]), ("l1_loss", [1024, 512, 256, 128, 64])):
        fn = MSSLoss(n_ffts, SR, loss_type=loss_type)
        tcs = fn.target_cache(gt)
        opt = torch.optim.Adam(list(sp.values()), lr=1e-3)

        def s2_step():
            opt.zero_grad(set_to_none=True)
            sig, damped = osc.forward_curve(osc_params, model.get_undamped_freqs_cached(sp, cache),
                                            cd, fz)
            fn(sig, None, damped, 1.0, target_cache=tcs).backward()
            model.bins.mask_grads(sp)
            opt.step()

        if loss_type == "geomloss":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            s2_step()
            torch.cuda.synchronize()
            log(f"stage 2 geomloss step at 8 mics: peak memory "
                f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above "
                f"{base / 2**30:.3f} GiB already allocated")
            profile_step("step profile, stage 2 geomloss (8 mics)", s2_step, steps=5,
                         profiled=2, kernels=("synth_fwd_kernel", "synth_bwd_kernel"))
        else:
            profile_step("step profile, stage 2 L1 (8 mics)", s2_step,
                         kernels=("synth_fwd_kernel", "synth_bwd_kernel"))

    # the chained run: stage 1's own curve into stage 2, on the coarser
    # cube_tet_mesh(6, 0.3) (6,591 DOF), whose two cold solves take seconds
    early, late = REAL_CHAINED_EPOCHS
    res2 = material_real.train_material_real(cube_tet_mesh(6, 0.3), audio, chained_curve,
                                             MatSet.Ceramic,
                                             max_epoch=early + late, early_loss_epoch=early,
                                             verbose=False)
    torch.cuda.synchronize()
    check = res2["losses"]
    log(f"chained stage 1 -> curve -> stage 2: Newton start E {res2['newton']['E']:.6g} nu "
        f"{res2['newton']['nu']:.5f}; loss {check[0]:.6g} -> {check[-1]:.6g}; E "
        f"{res2['youngs']:.6g} nu {res2['poisson']:.5f}; wall {res2['wall_s']:.3f} s")
    if not (np.isfinite(check).all() and len(check) == early + late and all(np.isfinite(
            [res2["newton"]["E"], res2["newton"]["nu"], res2["youngs"], res2["poisson"]]))):
        raise RuntimeError("chained stage 1 -> stage 2: non-finite values")
    real_cli(audio)
    return counts


def real_cli(audio):
    """material_real's CLI main on cube_tet_mesh(4, 0.3) with the recordings
    written as mic*.wav files: fresh (stage 1 of REAL_CLI's steps, the
    cache, stage 2), then from the stage-1 cache."""
    from diffsound_torch.audio.io import write_wav
    from diffsound_torch.experiments import material_real
    from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        mesh = cube_tet_mesh(4, 0.3)
        msh = os.path.join(tmp, "cube.msh")
        write_msh(msh, mesh.vertices, mesh.tets)
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        for i, x in enumerate(audio):
            write_wav(os.path.join(audio_dir, f"mic{i}.wav"), 0.5 * x, int(SR))
        with open(os.path.join(audio_dir, "metadata.yaml"), "w") as f:
            f.write("gain:\n- 0.0\n- 6.0\npad:\n- 0.0\n- 0.0\n")
        cfg = {"sample_rate": 32000, "frame_num": 8000, "force_frame_num": 150,
               "mesh_dir": msh, "audio_dir": audio_dir, "material": "Ceramic",
               "audio_num": 8, "mode_num": 16, "exp_mode": 3,
               "out_dir": os.path.join(tmp, "out"), **REAL_CLI}
        cfg_path = os.path.join(tmp, "real.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        for run in ("fresh", "cached"):
            t0 = time.perf_counter()
            zero_counts()
            res = material_real.main(["--config", cfg_path])
            counts = read_counts()
            with open(os.path.join(tmp, "out", "result.txt")) as f:
                fields = [line.strip().split(":", 1) for line in f if ":" in line]
            youngs, poisson = (float(v) for _, v in fields[-2:])
            log(f"cli material_real ({run}): result.txt E {youngs:.6g} nu {poisson:.5f} in "
                f"{time.perf_counter() - t0:.3f} s; synth launches {counts}")
            stage1 = REAL_CLI["gt_iters"] if run == "fresh" else 0
            want = {"synth_constant_modes": stage1 + REAL_CLI["max_epoch"],
                    "synth_constant_modes_bwd": stage1 + REAL_CLI["max_epoch"]
                    - REAL_CLI["early_loss_epoch"]}
            if not (math.isfinite(youngs) and math.isfinite(poisson)
                    and (youngs, poisson) == (res["youngs"], res["poisson"])):
                raise RuntimeError(f"cli material_real ({run}): bad result.txt")
            if any(counts[k] < n for k, n in want.items()):
                raise RuntimeError(f"cli material_real ({run}): synth kernels launched "
                                   f"{counts}, expected at least {want}")
            if not os.path.exists(os.path.join(tmp, "out", "stage1_fit.npz")):
                raise RuntimeError("cli material_real: no stage-1 cache written")


def cli_phase():
    """material_sync's CLI main on a small cube mesh, one pair, each recipe."""
    from diffsound_torch.experiments import material_sync
    from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh

    recipes = (
        ("newton", {"newton_rounds": 3, "polish_epochs": 30}, 30, 30),
        ("adam", {"max_epoch": 30, "early_loss_epoch": 0, "late_freq_weight": 0}, 30, 30),
        ("reference", {"max_epoch": 20, "early_loss_epoch": 10}, 20, 10),
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        mesh = cube_tet_mesh(4)
        msh = os.path.join(tmp, "cube.msh")
        write_msh(msh, mesh.vertices, mesh.tets)
        for recipe, extra, min_fwd, min_bwd in recipes:
            out_dir = os.path.join(tmp, recipe)
            cfg = {
                "sample_rate": 32000, "frame_num": 8000, "force_frame_num": 150,
                "mesh_dir": msh, "mesh_name": "cube", "mode_num": 16,
                "num_material_pairs": 1, "exp_mode": 3, "out_dir": out_dir,
                "recipe": recipe, **extra,
            }
            cfg_path = os.path.join(tmp, f"{recipe}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            t0 = time.perf_counter()
            zero_counts()
            material_sync.main(["--config", cfg_path])
            counts = read_counts()
            with open(os.path.join(out_dir, "result.txt")) as f:
                fields = dict(line.strip().split(":", 1) for line in f if ":" in line)
            youngs, poisson = float(fields["youngs"]), float(fields["poisson"])
            log(f"cli {recipe}: result.txt E {youngs:.6g} nu {poisson:.5f} RMSE "
                f"{float(fields['RMSE']):.5f} in {time.perf_counter() - t0:.3f} s; synth "
                f"kernel launches {counts['synth_constant_modes']}, backward "
                f"{counts['synth_constant_modes_bwd']}")
            if not (math.isfinite(youngs) and math.isfinite(poisson)):
                raise RuntimeError(f"cli {recipe}: result.txt holds non-finite E or nu")
            if counts["synth_constant_modes"] < min_fwd or \
                    counts["synth_constant_modes_bwd"] < min_bwd:
                raise RuntimeError(f"cli {recipe}: synth kernels launched {counts}")


# The shape phase: thickness and morphing at the configs' widths
# (configs/{thickness,morphing}_train.json: dmtet_grid 64, mesh_scale 1.5,
# Steel, order 1, the warm eigensolver) on procedural closed meshes written
# as OBJ files (the reference's frog and turtle are not in the repository).
# Sizes in OBJ units, before mesh_scale; scripts/jax_shape_reference.py holds
# the same numbers.
SHAPE_GRID, SHAPE_SCALE, SHAPE_MAT = 64, 1.5, "Steel"
# an icosphere(2): about 70k DOF at c 0.4-0.5, near the 67k of the JAX
# package's grid-64 frog calibration
THICKNESS_SPEC = dict(radius=0.22, modes=32, target=0.4)
# an icosphere(2) and an ellipsoid (the icosphere scaled per axis): the blend
# has 62,847 DOF at c 0.5 and 69,561 at 0.7
MORPHING_SPEC = dict(radius=0.237, axes=(0.273, 0.182, 0.146), modes=16, target=0.7)
# The JAX package's float64 numbers on these meshes (the CPU, host ARPACK):
# `python -m scripts.jax_shape_reference --task thickness` / `--task
# morphing`: the compact mesh's DOF at c 0.5, the target eigenvalues, and at
# c 0.5 on the host basis the Ritz values, dvals/dc and dl/dc, and the same
# pass's gaps in the JAX package's float32.
JAX_SHAPE = {
    "thickness": dict(
        dof_c05=69930, dldc_c05=1.0510833814265055,
        f32_gap_vals=1.9979203587427996e-05, f32_gap_dvals=0.0005749009379936691,
        dldc_c05_f32=1.0517062152510768,
        target_vals=(
            276815580.7690877, 276815580.7701469, 278356342.97455007, 280607415.99551994,
            280607415.99618405, 525768135.75433624, 525768135.76000315, 526819155.60827416,
            526819155.61017466, 527336314.8775565, 699844987.7447622, 701294224.2648724,
            713020424.0927424, 713020424.0941956, 717275617.235845, 719592012.5542159,
            719592012.5597053, 1108318115.3934157, 1302649370.0396929, 1309118096.3776503,
            1309118096.3784337, 1309839777.0690691, 1322638835.5318716, 1323102363.0113037,
            1323102363.0151105, 1375129627.9645932, 1377602523.6214924, 1377602523.6215425,
            1417586798.649143, 1417586798.6518478, 1447470071.6503952, 1452211298.318658,
        ),
        vals_c05=(
            352205440.264349, 352205440.2643575, 353934209.1328108, 356575861.86742955,
            356575861.8674362, 553954938.0062393, 553954938.0062478, 555145094.2409433,
            555145094.2409477, 555723847.9327302, 943679317.9228154, 945360775.5553983,
            957941406.1668917, 957941406.1668983, 962620926.2106974, 965470864.1790345,
            965470864.1790392, 1299038923.7282984, 1357272059.8344562, 1364920710.1532006,
            1364920710.1532075, 1365806474.1781166, 1374411345.560378, 1378643234.8360045,
            1378643234.8360095, 1380673335.3242893, 1380959617.5726757, 1380959617.5726795,
            1870218803.200761, 1870218803.200765, 1903039736.087231, 1907573529.636337,
        ),
        dvals_c05=(
            834519996.2605993, 834519996.2147896, 840420695.958851, 837881226.7933154,
            837881226.8074936, 234322818.3093146, 234322818.37542874, 237311930.53483275,
            237311930.62159395, 238121686.49713847, 2497192857.5524516, 2526166591.9035344,
            2521127404.9794607, 2521127404.8695173, 2529754248.7297797, 2534767970.5915112,
            2534767970.288291, 2153298990.2934055, 399043184.8856399, 409100968.061122,
            409100968.03064793, 406506125.19012636, -329594848.3335496,
            -310772647.15760684, -310772647.10005534, 429233367.50691336,
            424650582.3152729, 424650582.4017666, 4194334559.8468556, 4194334559.839674,
            4242419427.1363435, 4197481455.005442,
        ),
    ),
    "morphing": dict(
        dof_c05=62847, dldc_c05=-0.09555096472986421,
        f32_gap_vals=8.238591100107051e-06, f32_gap_dvals=0.006651257070689922,
        dldc_c05_f32=-0.09582883659059224,
        target_vals=(
            485022016.94972, 487844409.64310634, 517961283.70938545, 593612848.5670997,
            607144005.0497848, 636612295.1540004, 653621254.4281785, 668628739.5541209,
            671259744.6442653, 675947819.4394681, 1019796631.8974609, 1140384305.2009683,
            1191063831.59249, 1192183256.5638561, 1254395029.4892347, 1278998923.6124625,
        ),
        vals_c05=(
            450809509.318691, 466729868.13288856, 498863085.92897993, 605572308.2188903,
            638509214.2881079, 698161412.634852, 760410948.6515394, 764804151.0141708,
            774379624.4950787, 809589613.0851756, 1050142023.2039492, 1150796891.9954703,
            1156787997.9732008, 1282218439.6898963, 1298770048.1049836, 1361467819.9054475,
        ),
        dvals_c05=(
            213108152.39857054, 128644643.43700188, 144985831.809836, -40417908.01846595,
            -158047214.3492518, -333146611.11130726, -487171286.5988735,
            -480749964.9257059, -649380561.1331215, -776696724.3747593,
            -183788855.42687255, 256019795.58611846, 223721410.15960285, 68443454.29602712,
            -879188006.234807, -319338671.7345202,
        ),
    ),
}
# `CoefBins(32).init_params(jax.random.PRNGKey(0))` of the JAX package: the
# start of its Adam loop (ThicknessTask.optimize), from the same script
JAX_COEF_LOGITS = (
    -0.16308577656722711, -0.5674090907889773, 0.930642922237995, 0.1490010674550093,
    0.0644529765010855, -0.29018963946051146, 0.7660179523179806, 0.2651207805928286,
    0.06760015348762494, -0.6166922370414936, 0.7083533039093157, -0.881121418421916,
    0.28678342468524365, 0.9881423359883565, 0.20402922876416518, -0.22336769590704764,
    -0.40658315149176527, 0.2870877609193392, -0.15536180933377874, 0.8674384047774026,
    0.04708695716915168, 0.11258925892464244, 0.14952755164985998, 0.03727104342769216,
    -0.842488506529727, -0.15457838683375247, 0.7343021236472018, -0.9740552945257464,
    -0.42629016912677686, 0.23686119618088108, -0.7510416027798223, 0.010408078842656376,
)
# The card's Ritz pass at c 0.5 on the host basis against the JAX package's
# float64.  In float32 (the task's dtype on the card) the largest relative
# gap of the values and the relative norm of the dvals/dc error are held to
# SHAPE_F32_MARGIN times the JAX package's own float32 gap on the same mesh
# and basis (JAX_SHAPE's f32_gap_*), and dl/dc must keep JAX's float64
# sign: float32's own error in dvals/dc is 0.7% on the morphing blend and
# 6e-4 on the thickness shell in the JAX package, so a fixed gate would
# either miss a fault on the shell or fail f32 itself on the blend.  That
# error comes from the float32 rounding of the mesh's vertices, not from the
# device or the order of summation: `scripts/shape_f32_spread.py` reads the
# port's float32 on the CPU equal to the card's to three digits, and the
# mesh translated by a fraction of a grid cell (exactly invariant in exact
# arithmetic) moves the blend's gap over 5.0e-3 to 1.54e-2 and the shell's
# over 1.5e-4 to 4.0e-4, all below the margin of 4.
# The same pass in float64 on the card is held to 1e-8 in both (the CPU
# tests hold float64 to 1e-9; the two packages' ARPACK bases differ by
# rotations within the span).
SHAPE_F32_MARGIN = 4.0
SHAPE_F64_GATE = 1e-8
# Warm against cold at full width: after the thickness task's Adam steps
# (its basis at c ~0.45), one warm solve across the remesh to the target's
# c 0.4, against the target's host ARPACK solve on that same compact mesh.
# The gate: the solve is accepted warm (no host re-anchor) and its 32
# elastic eigenvalues lie within 1e-3 of ARPACK's.  A Ritz value's error
# is about the residual squared over the relative gap to the modes outside
# the block: at the float32 tolerance (relative residual 3e-3) 9e-6 over
# gaps down to 1% (the JAX package reads 1.5e-4 at a residual of 1e-2 on
# the grid-64 frog, warm_eigs.py:84-86).  A solve may end
# above the tolerance at the 240-iteration cap and still be accepted below
# the escalation bound (3e-2); the residual is printed, and the
# eigenvalue gate holds either way.
WARM_GATE = 1e-3


def shape_meshes(tmp):
    """The phase's OBJ meshes, written and read back: {name: (verts, faces)}."""
    import numpy as np

    from diffsound_torch.fem.mesh import icosphere, read_obj, write_obj

    v, f = icosphere(2, MORPHING_SPEC["radius"])
    shapes = {"ball": icosphere(2, THICKNESS_SPEC["radius"]), "morph_ball": (v, f),
              "morph_egg": (v / MORPHING_SPEC["radius"] * np.array(MORPHING_SPEC["axes"]), f)}
    out = {}
    for name, (v, f) in shapes.items():
        path = os.path.join(tmp, f"{name}.obj")
        write_obj(path, v, f)
        out[name] = read_obj(path)
    return out


class ShapeProbe:
    """Records a shape task's parts by wrapping its methods on the instance:
    each host ARPACK solve (seconds, DOF), each warm solve (ms, LOBPCG
    iterations including an escalation round, residual, mode) and each
    Ritz value-and-derivative pass (c, values, dvals/dc, ms, peak memory)."""

    def __init__(self, task):
        import torch

        self.cold, self.warm, self.jac = [], [], []
        host, solve, jac = task._eigensolve_host, task.warm.solve, task._coef_vals_jac

        def eigensolve_host(out, comp):
            t0 = time.perf_counter()
            r = host(out, comp)
            self.cold.append((time.perf_counter() - t0, 3 * comp["num_verts"]))
            return r

        def warm_solve(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve(*args, **kw)
            torch.cuda.synchronize()
            w = task.warm
            if w.last_mode != "cold":
                self.warm.append(dict(ms=1e3 * (time.perf_counter() - t0), mode=w.last_mode,
                                      iters=w.last_iterations, resid=w.last_resid))
            return r

        def coef_vals_jac(c, comp, U):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            vals, dvals = jac(c, comp, U)
            torch.cuda.synchronize()
            rec = dict(c=c, mode=task.warm.last_mode, vals=vals, dvals=dvals,
                       ms=1e3 * (time.perf_counter() - t0),
                       peak=torch.cuda.max_memory_allocated() - base, dof=3 * comp["num_verts"])
            if not self.jac:
                # the first pass (the point the JAX gate reads) once more in
                # float64 on the card
                dtype, task.dtype = task.dtype, torch.float64
                rec["f64"] = jac(c, comp, U)
                task.dtype = dtype
            self.jac.append(rec)
            return vals, dvals

        task._eigensolve_host = eigensolve_host
        task.warm.solve = warm_solve
        task._coef_vals_jac = coef_vals_jac

    def report(self, label):
        import numpy as np

        log(f"{label}: {len(self.cold)} cold solves (host ARPACK), seconds "
            f"{fmt((s for s, _ in self.cold), 3)} at DOF {[d for _, d in self.cold]}")
        log(f"{label}: {len(self.warm)} warm solves, ms {fmt((w['ms'] for w in self.warm), 1)}; "
            f"LOBPCG iterations {[w['iters'] for w in self.warm]}; max residual "
            f"{' '.join(f'{w['resid']:.2e}' for w in self.warm)}; modes "
            f"{sorted(set(w['mode'] for w in self.warm))}")
        ms = [j["ms"] for j in self.jac]
        log(f"{label}: {len(ms)} Ritz value-and-derivative passes (forward mode), ms "
            f"{fmt(ms, 1)}; peak memory above the resident {max(j['peak'] for j in self.jac) / 2**20:.1f} "
            f"MiB (median pass {np.median(ms):.1f} ms)")


def shape_gate(label, probe, ref):
    """The card's float32 Ritz values and dvals/dc at c 0.5 on the host
    basis (the first Newton iteration) against the JAX package's float64."""
    import numpy as np

    first = probe.jac[0]
    if not (first["c"] == 0.5 and first["mode"] == "cold"):
        raise RuntimeError(f"{label}: the first Ritz pass ran at c {first['c']} on a "
                           f"{first['mode']} basis, not at 0.5 on the host basis")
    want_v, want_d = np.asarray(ref["vals_c05"]), np.asarray(ref["dvals_c05"])
    target = np.asarray(ref["target_vals"])

    def gaps(vals, dvals):
        r = (vals - target) / target
        return (float(np.abs(vals / want_v - 1).max()),
                float(np.linalg.norm(dvals - want_d) / np.linalg.norm(want_d)),
                float(2.0 * np.mean(r * dvals / target)))

    gap_v, gap_d, dldc = gaps(first["vals"], first["dvals"])
    gap_v64, gap_d64, dldc64 = gaps(*first["f64"])
    gate_v = SHAPE_F32_MARGIN * ref["f32_gap_vals"]
    gate_d = SHAPE_F32_MARGIN * ref["f32_gap_dvals"]
    log(f"{label}: at c 0.5 on the host basis ({first['dof']} DOF, JAX {ref['dof_c05']}), "
        f"card f32 against JAX f64: values {gap_v:.3e} (JAX f32 {ref['f32_gap_vals']:.3e}, "
        f"gate {gate_v:.3e}), dvals/dc {gap_d:.3e} in relative norm (JAX f32 "
        f"{ref['f32_gap_dvals']:.3e}, gate {gate_d:.3e}); dl/dc {dldc:.6g} against JAX's "
        f"{ref['dldc_c05']:.6g} (JAX f32 {ref['dldc_c05_f32']:.6g}); card f64: {gap_v64:.3e}, "
        f"{gap_d64:.3e} (gate {SHAPE_F64_GATE:.0e}), dl/dc {dldc64:.9g}; Ritz pass "
        f"{first['ms']:.1f} ms, peak {first['peak'] / 2**20:.1f} MiB")
    if first["dof"] != ref["dof_c05"]:
        raise RuntimeError(f"{label}: the compact mesh at c 0.5 has {first['dof']} DOF, "
                           f"the JAX package's {ref['dof_c05']}")
    if not (gap_v <= gate_v and gap_d <= gate_d
            and np.sign(dldc) == np.sign(ref["dldc_c05"])
            and max(gap_v64, gap_d64) <= SHAPE_F64_GATE):
        raise RuntimeError(f"{label}: the card's Ritz values or derivative disagree with "
                           f"the JAX package's beyond the gates")


def profile_once(label, fn):
    """Host wall time and device work of one call of fn (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    work = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in work)
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    log(f"{label}: host {host_ms:.1f} ms, device work {device_ms:.1f} ms (idle share "
        f"{1 - device_ms / host_ms:.3f}), {launches} cudaLaunchKernel calls")
    if not 0 < device_ms < host_ms:
        raise RuntimeError(f"{label}: device work {device_ms:.3f} ms against {host_ms:.3f} ms")
    return host_ms, device_ms


def march_compact_times(label, task, c, reps=3):
    """Logs the ms of the device march and of the host compaction at c, and
    the bytes the compaction moves from the card (the valid sub-tets, int32,
    and their corners, float64)."""
    import torch

    from diffsound_torch.geometry.dmtet import MarchingTets

    march, compact = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = task._march_coef(c)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        comp = MarchingTets.compact(out)
        march.append(1e3 * (t1 - t0))
        compact.append(1e3 * (time.perf_counter() - t1))
    n_valid = int(out.tet_mask.sum())
    moved = n_valid * (4 * 4 + 4 * 3 * 8)
    log(f"{label}: march {fmt(march, 2)} ms, compact {fmt(compact, 2)} ms at c {c:.4f} "
        f"({out.sub_tets.shape[0]} sub-tet slots, {n_valid} valid, {moved / 2**20:.2f} MiB "
        f"to the host; {3 * comp['num_verts']} DOF, {comp['num_tets']} tets)")


def shape_task(kind, meshes):
    """One task at full width: setup, target, Newton from 0.5 (then, for
    thickness, ten Adam steps on the same object).  Returns its launch
    counts."""
    import numpy as np
    import torch

    from diffsound_torch.geometry.tasks import MorphingTask, ThicknessTask

    spec = THICKNESS_SPEC if kind == "thickness" else MORPHING_SPEC
    ref = JAX_SHAPE[kind]
    zero_counts()
    t_task = t0 = time.perf_counter()
    cls = ThicknessTask if kind == "thickness" else MorphingTask
    task = cls(grid_res=SHAPE_GRID, scale=SHAPE_SCALE, mat=SHAPE_MAT, mode_num=spec["modes"])
    t1 = time.perf_counter()
    if kind == "thickness":
        v, f = meshes["ball"]
        task.apply_sdf(v * SHAPE_SCALE, f)
    else:
        (v1, f1), (v2, f2) = meshes["morph_ball"], meshes["morph_egg"]
        task.apply_sdf2(v1 * SHAPE_SCALE, f1, v2 * SHAPE_SCALE, f2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"shape {kind}: setup {t2 - t0:.3f} s (background grid and edges {t1 - t0:.3f} s, "
        f"signed distances on the card {t2 - t1:.3f} s); {task.marching.num_grid_verts} grid "
        f"vertices, {task.marching.num_edges} edges, {len(task.marching.grid_tets)} tets")
    probe = ShapeProbe(task)
    t0 = time.perf_counter()
    target = task.eigenvalues(spec["target"])
    tgt_gap = float(np.abs(target / np.asarray(ref["target_vals"]) - 1).max())
    log(f"shape {kind}: target eigenvalues at c {spec['target']} in "
        f"{time.perf_counter() - t0:.3f} s, {tgt_gap:.3e} from the JAX package's")
    if tgt_gap > 1e-8:
        raise RuntimeError(f"shape {kind}: host ARPACK targets {tgt_gap:.3e} from JAX's")
    t0 = time.perf_counter()
    c, hist = task.newton_optimize(target, iters=40 if kind == "thickness" else 25, c0=0.5,
                                   verbose=False)
    torch.cuda.synchronize()
    newton_s = time.perf_counter() - t0
    gate = 0.02 if kind == "thickness" else 0.05
    log(f"shape {kind}: Newton {spec['target']} <- 0.5 ended at {c:.6f} ({abs(c - spec['target']):.2e} "
        f"off, gate {gate}) in {len(hist)} iterations, {newton_s:.3f} s; iterations' s "
        f"{fmt((h['dt'] for h in hist), 3)}; losses {' '.join(f'{h['loss']:.3e}' for h in hist)}")
    shape_gate(f"shape {kind}", probe, ref)
    if not abs(c - spec["target"]) < gate:
        raise RuntimeError(f"shape {kind}: Newton ended at {c}, not within {gate} of "
                           f"{spec['target']}")
    if kind == "thickness":
        t0 = time.perf_counter()
        params = {"coef_logits": torch.tensor(JAX_COEF_LOGITS, dtype=torch.float64)}
        c_start = task.bins.coef(params)
        _, ahist = task.optimize(target, iters=10, lr=2e-2, params=params, verbose=False)
        adam_s = time.perf_counter() - t0
        losses = np.array([h["loss"] for h in ahist])
        log(f"shape thickness: 10 Adam steps (lr 2e-2) from the JAX package's PRNGKey(0) "
            f"bins: coef {c_start:.5f} -> {ahist[-1]['coef']:.5f} in {adam_s:.3f} s; losses "
            f"{' '.join(f'{x:.4e}' for x in losses)}; skipped "
            f"{sum(h['skipped'] for h in ahist)}; eigensolves "
            f"{[(h['eig_mode'], h['eig_iters']) for h in ahist]}")
        if not (np.isfinite(losses).all()
                and abs(ahist[-1]["coef"] - spec["target"]) < abs(c_start - spec["target"])):
            raise RuntimeError("shape thickness: the Adam steps did not move toward the target")
        warm_check(task, target, spec["target"])
    probe.report(f"shape {kind}")
    march_compact_times(f"shape {kind}", task, c)

    def newton_iteration():
        from diffsound_torch.geometry.dmtet import MarchingTets

        o = task._march_coef(c + 0.01)
        cp = MarchingTets.compact(o)
        _, U = task._eigensolve(o, cp)
        task._coef_vals_jac(c + 0.01, cp, U)

    profile_once(f"shape {kind}: one Newton iteration (warm, c {c + 0.01:.4f})", newton_iteration)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"shape {kind}: {time.perf_counter() - t_task:.3f} s in all; synth launches {counts}")
    return counts


def warm_check(task, target, c):
    """A warm solve from the task's stored basis across the remesh to c,
    against `target`, the host ARPACK eigenvalues of the same compact mesh
    (WARM_GATE)."""
    import numpy as np
    import torch

    from diffsound_torch.geometry.dmtet import MarchingTets

    out = task._march_coef(c)
    comp = MarchingTets.compact(out)
    overlap = task.warm.overlap(comp)
    t0 = time.perf_counter()
    vals, _ = task._eigensolve(out, comp)
    torch.cuda.synchronize()
    w = task.warm
    err = float(np.abs(vals[6:] / target - 1).max())
    log(f"shape warm check: {3 * comp['num_verts']} DOF at c {c} (slot overlap "
        f"{overlap:.4f}); {w.last_mode} solve in {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"{w.last_iterations} LOBPCG iterations, residual {w.last_resid:.2e} (tol {w.tol}); "
        f"max relative error over the {len(target)} elastic modes against the target's host "
        f"ARPACK {err:.3e} (gate {WARM_GATE:.0e})")
    if not (w.last_mode == "warm" and err <= WARM_GATE):
        raise RuntimeError("shape warm check: the warm solve disagrees with host ARPACK")


def shape_cli(meshes, tmp):
    """thickness.main and morphing.main at grid 16, one target each, both
    optimizers."""
    import numpy as np

    from diffsound_torch.experiments import morphing, thickness

    for name, mod, extra in (
            ("thickness", thickness, {"mesh_name": "ball", "thickness_list": [0.4]}),
            ("morphing", morphing, {"mesh_name1": "morph_ball", "mesh_name2": "morph_egg",
                                    "morphing_list": [0.7]})):
        for optimizer in ("newton", "adam"):
            out_dir = os.path.join(tmp, f"{name}_{optimizer}")
            cfg = {"iter": 5, "learning_rate": 2e-2, "out_dir": out_dir, "init_mesh_dir": tmp,
                   "mesh_scale": SHAPE_SCALE, "dmtet_grid": 16, "mat": SHAPE_MAT,
                   "optimizer": optimizer, **extra}
            path = os.path.join(tmp, f"{name}_{optimizer}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            t0 = time.perf_counter()
            zero_counts()
            (target, result), = mod.main(["--config", path])
            counts = read_counts()
            files = sorted(os.listdir(out_dir))
            log(f"cli {name} ({optimizer}): target {target} result {result:.6f} in "
                f"{time.perf_counter() - t0:.3f} s; wrote {files}; synth launches {counts}")
            if not (np.isfinite(result) and 0.0 < result < 1.0 and any(
                    fn.startswith("result_") for fn in files)):
                raise RuntimeError(f"cli {name} ({optimizer}): bad result")
            if name == "thickness" and not os.path.exists(
                    os.path.join(out_dir, "ball", f"result{target}.obj")):
                raise RuntimeError("cli thickness: no recovered surface written")


def shape_phase():
    """Thickness and morphing at full width, then the CLIs.  The two tasks
    run at once, morphing in a second process: each spends most of its
    time in host ARPACK, which uses one core; the per-task times it logs
    are taken side by side.  A morphing process that dies raises
    BrokenProcessPool here.  Returns each task's launch counts of the
    synthesis kernels."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shape_") as tmp:
        meshes = shape_meshes(tmp)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            morphing = pool.submit(shape_task, "morphing", meshes)
            launches["thickness"] = shape_task("thickness", meshes)
            launches["morphing"] = morphing.result()
        log(f"shape thickness and morphing, concurrently: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        shape_cli(meshes, tmp)
        log(f"shape cli: {time.perf_counter() - t0:.3f} s")
    return launches


# The geometry phase: configs/geometry_train.json's widths (grid 32: 35,937
# grid vertices, 6 tets a cube; freq_num 3, so 21 input features; the SDF
# MLP 21 -> 512 x 4 -> 1; 64 modes + 6, 8 warm guard columns; voxel 16, so
# 4,096 query points; Ceramic, order 1, the warm solver re-anchoring every
# 50) on a procedural ground truth (bob, oloid and spot are not in the
# repository): the ellipsoid below in a unit box, marched and compacted at
# grid 32, written as a .msh and its surface as an OBJ, as the CLI reads
# them.  The start is pretrained toward the same ellipsoid scaled by
# `start`, then `iters` optimize iterations at `lr` (the JAX package's test
# rate; the config's 1e-5 moves the loss too little in 20 iterations to
# gate on).
GEOMETRY_SPEC = dict(axes=(0.45, 0.32, 0.26), grid=32, voxel=16, modes=64, freq_num=3,
                     start=1.2, pretrain=2000, pretrain_lr=1e-4, lr=3e-4, iters=20)
# The JAX package's own float32 gap on this recipe, from `JAX_PLATFORMS=cpu
# python -m scripts.jax_geometry_reference`: at its pretrained start, on its
# compaction and host ARPACK basis, its float32 pass (float32 throughout:
# grid, MLP, march, element operators) against its float64 one: the relative
# gaps of the loss and of the eigenvalue loss, and the relative norm errors
# of the loss's gradient, of the eigenvalue loss's gradient (every
# parameter) and of its deform part.  The card's f32 loss, eigenvalue loss
# and gradient are held to GEOMETRY_F32_MARGIN times JAX's.  JAX's own
# float32 eigenvalue-loss gradient is 5x off (its deform part 217x, from a
# few sliver tets), so it is no yardstick for the port's.
JAX_GEOMETRY = {
    "dof_gt": 35637, "dof_start": 55506,
    "gt_vals_head": (290923770.4134254, 343325639.0113079, 356823157.04888844,
                     513335313.03776294),
    "f32_gap_loss": 7.533405290693906e-07, "f32_gap_eig": 5.8017565699453044e-05,
    "f32_gap_grad": 0.0001306294267665887, "f32_gap_eig_grad": 4.967027132379415,
    "f32_gap_deform_grad": 216.88353063659142,
}
GEOMETRY_F32_MARGIN = 4.0
# The card's f32 eigenvalue-loss gradient in the MLP's parameters (what
# moves the SDF; deform's part, a per-vertex field that sliver tets
# dominate, is printed and not gated), in relative norm from the CPU's f64
# at the start: read 2.95e-2 on the H100 (with deform).  A zero or
# sign-flipped gradient reads 1 or 2, and the same pass with TF32 on (which
# the package keeps off) must read above the gate too.
GEOMETRY_EIG_GRAD_GATE = 0.1


def ellipsoid_sdf(points, axes):
    """Inside-positive, distance-scaled implicit ellipsoid: min(axes) (1 -
    |x / axes|) at points (n, 3), numpy float64."""
    import numpy as np

    axes = np.asarray(axes, np.float64)
    return axes.min() * (1.0 - np.sqrt(((np.asarray(points) / axes) ** 2).sum(-1)))


def geometry_gt_files(tmp, grid, device):
    """The ground truth: the ellipsoid marched and compacted at `grid` in a
    unit box, written as tmp/gt.msh and its surface as tmp/gt_surf.obj.
    Returns the DOF."""
    import numpy as np
    import torch

    from diffsound_torch.fem.mesh import TetMesh, write_obj
    from diffsound_torch.geometry.dmtet import MarchingTets
    from diffsound_torch.geometry.grid import generate_background_grid

    gv, gtets = generate_background_grid(grid)
    gv = gv.astype(np.float64)
    mt = MarchingTets(gv, gtets, device=device)
    sdf = ellipsoid_sdf(gv, GEOMETRY_SPEC["axes"])
    out = mt(torch.as_tensor(gv, device=mt.device), torch.as_tensor(sdf, device=mt.device))
    comp = MarchingTets.compact(out)
    rows = torch.as_tensor(comp["keep_idx"][: comp["num_verts"]], device=mt.device)
    TetMesh(out.all_verts[rows].cpu().numpy(), comp["tets"][: comp["num_tets"]]).export(
        os.path.join(tmp, "gt.msh"))
    write_obj(os.path.join(tmp, "gt_surf.obj"), *MarchingTets.compact_triangles(out))
    return 3 * comp["num_verts"]


def voxel_constraint(tmp, voxel, device):
    """The CLI's constraint: the surface OBJ centred, its size, the voxel
    lattice Q * size and the signed distances there (numpy)."""
    import numpy as np

    from diffsound_torch.fem.mesh import read_obj
    from diffsound_torch.geometry.sdf_host import mesh_signed_distance

    sv, sf = read_obj(os.path.join(tmp, "gt_surf.obj"))
    lo, hi = sv.min(0), sv.max(0)
    center, size = (lo + hi) / 2, float((hi - lo).max()) * 1.05
    xs = np.linspace(-0.5, 0.5, voxel)
    Q = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3) * size
    sd = mesh_signed_distance(Q, sv - center, sf, device)
    return center, size, Q, np.asarray(sd.cpu())


def geometry_pass(task, params, comp, U, target, q, sd):
    """One reverse-mode pass of the geometry loss at params on the
    compaction comp and basis U: (loss, eig_loss, the loss's gradient, the
    eigenvalue loss's gradient), each gradient one float64 CPU vector over
    every MLP parameter and deform (in that order)."""
    import torch

    from diffsound_torch.geometry.geometry_task import _leaves

    p, leaves = _leaves(params)
    loss, (_, eig) = task._loss_core(p, comp, U, target, q, sd, 0.0)
    g = torch.autograd.grad(loss, leaves, retain_graph=True)
    g_eig = torch.autograd.grad(eig, leaves)
    flat = lambda gs: torch.cat([x.reshape(-1) for x in gs]).double().cpu()
    return loss.item(), eig.item(), flat(g), flat(g_eig)


GEOMETRY_GAPS = ("loss", "eig", "grad", "eig_grad_mlp", "eig_grad", "deform_grad")


def geometry_gaps(a, b, n_deform):
    """GEOMETRY_GAPS of pass a against the reference pass b: the relative
    gaps of the loss and of the eigenvalue loss; in relative norm the
    errors of the loss's gradient and of the eigenvalue loss's gradient in
    the MLP's parameters, in every parameter and in deform."""
    rel = lambda x, y: float((x - y).norm() / y.norm())
    return (abs(a[0] / b[0] - 1), abs(a[1] / b[1] - 1), rel(a[2], b[2]),
            rel(a[3][:-n_deform], b[3][:-n_deform]), rel(a[3], b[3]),
            rel(a[3][-n_deform:], b[3][-n_deform:]))


def geometry_phase():
    """The geometry task at the config's widths on the ellipsoid ground
    truth: its eigenvalues, the voxel constraint, the pretrained start,
    GEOMETRY_SPEC["iters"] optimize iterations; the card's f32 pass against
    the CPU's f64 at the start's compaction and host basis; a warm solve
    against host ARPACK at the final mesh; one iteration's profile; then the
    geometry CLI at grid 16.  Returns the synthesis kernels' launch counts."""
    import numpy as np
    import torch

    from diffsound_torch.fem.mesh import TetMesh
    from diffsound_torch.geometry.dmtet import MarchingTets
    from diffsound_torch.geometry.geometry_task import GeometryTask
    from diffsound_torch.geometry.sdf_mlp import cast_params

    spec, ref = GEOMETRY_SPEC, JAX_GEOMETRY
    tmp = tempfile.mkdtemp(prefix="chip_smoke_geometry_")
    zero_counts()
    t_phase = t0 = time.perf_counter()
    dof_gt = geometry_gt_files(tmp, spec["grid"], "cuda")
    center, size, Q, sd = voxel_constraint(tmp, spec["voxel"], "cuda")
    log(f"geometry: ground truth {dof_gt} DOF (JAX {ref['dof_gt']}), voxel {spec['voxel']} "
        f"constraint ({len(Q)} points, size {size:.6f}) in {time.perf_counter() - t0:.3f} s")
    task = GeometryTask(grid_res=spec["grid"], scale=size, freq_num=spec["freq_num"],
                        mode_num=spec["modes"])
    n_mlp = sum(v.numel() for v in task.init_params(torch.Generator())["mlp"].values())
    log(f"geometry: {task.marching.num_grid_verts} grid vertices, "
        f"{len(task.marching.grid_tets)} tets, {task.marching.num_edges} edges; SDF MLP "
        f"{[task.geo.net.layers[0].in_features] + [l.out_features for l in task.geo.net.layers]}"
        f" ({n_mlp} parameters); {spec['modes']} + {task.extra_modes} modes, "
        f"{task.warm.guards} guard columns, re-anchor every {task.warm.reanchor_every}")
    gt_mesh = TetMesh.from_file(os.path.join(tmp, "gt.msh"))
    t0 = time.perf_counter()
    gt_vals = task.gt_eigenvalues_from_mesh(TetMesh(gt_mesh.vertices - center, gt_mesh.tets))
    log(f"geometry: ground-truth eigenvalues (cold host ARPACK, {spec['modes']} + 6 modes) in "
        f"{time.perf_counter() - t0:.3f} s; first four {fmt(gt_vals[:4], 6)} (JAX "
        f"{fmt(ref['gt_vals_head'], 6)})")
    if dof_gt != ref["dof_gt"] or np.abs(gt_vals[:4] / np.asarray(ref["gt_vals_head"]) - 1
                                         ).max() > 1e-8:
        raise RuntimeError("geometry: the ground truth's mesh or eigenvalues differ from the "
                           "JAX package's")

    params = task.init_params(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_sd = ellipsoid_sdf(Q, spec["start"] * np.asarray(spec["axes"]))
    params = task.pretrain_sdf(params, Q, start_sd, iters=spec["pretrain"], lr=spec["pretrain_lr"])
    torch.cuda.synchronize()
    log(f"geometry: pretraining ({spec['pretrain']} full-batch Adam steps at lr "
        f"{spec['pretrain_lr']}) toward the ellipsoid x {spec['start']} in "
        f"{time.perf_counter() - t0:.3f} s")

    # the first iteration's host basis, for the f32 check at the start
    first = {}
    host = task._eigensolve_host

    def eigensolve_host(out, comp, k):
        t0 = time.perf_counter()
        r = host(out, comp, k)
        log(f"geometry: cold host ARPACK at {3 * comp['num_verts']} DOF in "
            f"{time.perf_counter() - t0:.3f} s")
        first.setdefault("comp", comp)
        first.setdefault("U", r[1])
        return r

    task._eigensolve_host = eigensolve_host
    # the params of the last step, for the profile of one iteration below
    stepped = []
    step = task.step_loss_grad

    def step_loss_grad(p, *args, **kw):
        stepped[:] = [{"mlp": {k: v.detach().clone() for k, v in p["mlp"].items()},
                       "deform": p["deform"].detach().clone()}]
        return step(p, *args, **kw)

    task.step_loss_grad = step_loss_grad
    start = params
    t0 = time.perf_counter()
    params, best, hist = task.optimize(params, gt_vals, Q, sd, iters=spec["iters"], lr=spec["lr"],
                                       verbose=False)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    for r in hist:
        log(f"geometry iter {r['iter']}: " + (f"skipped ({r['skipped']})" if "skipped" in r else
            f"loss {r['loss']:.6f} (template {r['template']:.6f}, eig {r['eig']:.6f}); march "
            f"{1e3 * r['march_s']:.1f} ms, compaction {1e3 * r['compact_s']:.1f} ms, solve "
            f"{1e3 * r['solve_s']:.1f} ms ({r['solve_mode']}, {r['solve_iters']} LOBPCG "
            f"iterations), loss-gradient {1e3 * r['loss_grad_s']:.1f} ms"))
    done = [r for r in hist if "skipped" not in r]
    eigs = np.array([r["eig"] for r in done])
    log(f"geometry: {spec['iters']} iterations (lr {spec['lr']}) in {opt_s:.3f} s; eig loss "
        f"{eigs[0]:.6f} -> {eigs[-1]:.6f}, best mesh at loss {best['loss']:.6f} (eig "
        f"{best['eig_loss']:.6f}, {3 * len(best['verts'])} DOF); warm {task.warm.total_warm}, "
        f"cold {task.warm.total_cold}")
    if len(done) != len(hist) or len(hist) != spec["iters"]:
        raise RuntimeError("geometry: an iteration was skipped")
    if not np.isfinite([[r["loss"], r["template"], r["eig"]] for r in done]).all():
        raise RuntimeError("geometry: a loss is not finite")
    if not best["eig_loss"] < eigs[0]:
        raise RuntimeError(f"geometry: the best mesh's eig loss {best['eig_loss']} is not "
                           f"below iteration 0's {eigs[0]}")

    # f32 on the card against f64 on the CPU at the start's params,
    # compaction and host basis
    cpu = GeometryTask(grid_res=spec["grid"], scale=size, freq_num=spec["freq_num"],
                       mode_num=spec["modes"], eig_method="host", device="cpu")
    comp, U = first["comp"], first["U"]
    qd, sdd = task._tensor(Q), task._tensor(sd)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task.loss_grad(start, comp, U, gt_vals, qd, sdd)
    torch.cuda.synchronize()
    pass_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    card = geometry_pass(task, start, comp, U, gt_vals, qd, sdd)
    # the control: the same pass with TF32 on in every f32 product
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = geometry_pass(task, start, comp, U, gt_vals, qd, sdd)
    finally:
        torch.set_float32_matmul_precision("highest")
    start64 = {"mlp": {k: v.cpu() for k, v in cast_params(start, torch.float64)["mlp"].items()},
               "deform": start["deform"].double().cpu()}
    host64 = geometry_pass(cpu, start64, comp, U, gt_vals, cpu._tensor(Q), cpu._tensor(sd))
    n_def = start["deform"].numel()
    gaps = dict(zip(GEOMETRY_GAPS, geometry_gaps(card, host64, n_def)))
    control = dict(zip(GEOMETRY_GAPS, geometry_gaps(tf32, host64, n_def)))
    gates = {n: GEOMETRY_F32_MARGIN * ref["f32_gap_" + n] for n in ("loss", "eig", "grad")}
    gates["eig_grad_mlp"] = GEOMETRY_EIG_GRAD_GATE
    log(f"geometry precision at the start ({3 * comp['num_verts']} DOF, JAX's start "
        f"{ref['dof_start']}): card f32 loss {card[0]!r} eig {card[1]!r} vs cpu f64 "
        f"{host64[0]!r} {host64[1]!r}; " + ", ".join(
            f"{n} {g:.3e} (" + (f"JAX f32 {ref['f32_gap_' + n]:.3e}, " if n != "eig_grad_mlp"
                               else "") + (f"gate {gates[n]:.3e}" if n in gates else "no gate")
            + f"; TF32 control {control[n]:.3e})" for n, g in gaps.items()))
    log(f"geometry: the loss-gradient pass at the start {pass_ms:.1f} ms, peak memory "
        f"{peak / 2**20:.1f} MiB above {base / 2**20:.1f} MiB resident")
    if not all(gaps[n] <= g for n, g in gates.items()):
        raise RuntimeError("geometry: the card's f32 loss or gradient is further from f64 than "
                           "its gate")
    if not control["eig_grad_mlp"] > GEOMETRY_EIG_GRAD_GATE:
        raise RuntimeError("geometry: the TF32 control passes the eigenvalue-gradient gate")

    # after the run, a warm solve at the final params (one more remesh
    # from the last iteration's basis) against host ARPACK on its
    # compaction, with the task's own solver settings
    with torch.no_grad():
        out = task._march_params(cast_params(params, torch.float64))
    comp = MarchingTets.compact(out)
    mu, lam = task._lame()
    k = spec["modes"] + task.extra_modes
    overlap = task.warm.overlap(comp)

    def no_host_solve():
        raise RuntimeError("geometry warm check: the warm solver fell back to a host solve")

    w = task.warm
    t0 = time.perf_counter()
    vals, _ = w.solve(out, comp, float(mu), float(lam), host_solve=no_host_solve)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    want, _ = task._eigensolve_host(out, comp, k)
    err = float(np.abs(vals[6:] / want[6:] - 1).max())
    log(f"geometry warm check at the final params ({3 * comp['num_verts']} DOF, slot overlap "
        f"{overlap:.4f}): {w.last_mode} solve (cap {w.max_iters} a round, accepted at residual "
        f"{w.accept_resid}) {warm_ms:.1f} ms, {w.last_iterations} LOBPCG "
        f"iterations, residual {w.last_resid:.2e} (tol {w.tol}); max relative error over "
        f"{spec['modes']} elastic modes against host ARPACK {err:.3e} (gate {WARM_GATE:.0e})")
    if not (w.last_mode == "warm" and err <= WARM_GATE):
        raise RuntimeError("geometry warm check: the warm solve disagrees with host ARPACK")

    # one iteration: the last step's params from the final params' basis, a
    # remesh of one Adam step
    q, s = task._tensor(Q), task._tensor(sd)
    profile_once("geometry: one iteration (the last step's params, a one-step remesh)",
                 lambda: step(stepped[0], gt_vals, q, s))
    log(f"geometry: that iteration's solve: {w.last_mode}, {w.last_iterations} LOBPCG "
        f"iterations, residual {w.last_resid:.2e}")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"geometry: task {time.perf_counter() - t_phase:.3f} s in all; synth launches {counts}")
    geometry_cli(tmp)
    return counts


def geometry_cli(tmp):
    """experiments.geometry.main at grid 16, voxel 8, 16 modes, 3
    iterations on the phase's ground truth."""
    import numpy as np

    from diffsound_torch.experiments import geometry

    out_dir = os.path.join(tmp, "cli")
    cfg = {"iter": 3, "learning_rate": GEOMETRY_SPEC["lr"], "out_dir": out_dir,
           "init_mesh_dir": tmp, "mesh_name_list": ["gt"], "mode_num_list": [16],
           "voxel_num_list": [8], "grid_res": 16, "freq_num": GEOMETRY_SPEC["freq_num"]}
    path = os.path.join(tmp, "geometry.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    (_, _, _, eig_loss, hist), = geometry.main(["--config", path])
    files = sorted(os.listdir(os.path.join(out_dir, "8")))
    log(f"cli geometry: {len(hist)} iterations, best eig loss {eig_loss:.6f} in "
        f"{time.perf_counter() - t0:.3f} s; wrote {files}")
    if not ("gt_16.msh" in files and "metrics.jsonl" in files and np.isfinite(eig_loss)):
        raise RuntimeError("cli geometry: no best mesh or metric log")


def leftovers_phase(dev):
    """The stress path, TinyNN, lobpcg_solver_freq and BEM on the card
    `dev`."""
    import numpy as np
    import torch

    from diffsound_torch.acoustics import BEMModel
    from diffsound_torch.acoustics.bem import AIR_DENSITY, SPEED_OF_SOUND
    from diffsound_torch.fem import assembly
    from diffsound_torch.fem.material import TinyNN, lame_params, linear_stress
    from diffsound_torch.fem.mesh import cube_tet_mesh, icosphere
    from diffsound_torch.solvers.arpack import eigsh_shift_invert
    from diffsound_torch.solvers.lobpcg import lobpcg_solver_freq

    rel = lambda a, b: float((a.double().cpu() - b).norm() / b.norm())

    # the stress path through linear_stress against the factored k_matvec:
    # card f32 against CPU f64, beside the factored path's own f32 error
    mesh = cube_tet_mesh(9, 0.3).to_high_order(2)
    youngs, poisson = MAT[1] / MAT[0], MAT[2]
    mu, lam = lame_params(youngs, poisson)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((3 * mesh.num_vertices, 8)))
    v64 = torch.as_tensor(mesh.vertices)
    ref = assembly.k_matvec(assembly.build_element_ops(v64, mesh.tets, 2), x, mu, lam)
    v32, x32 = v64.to(dev, torch.float32), x.to(dev, torch.float32)
    t0 = time.perf_counter()
    dops = assembly.build_deform_ops(v32, mesh.tets, 2)
    y_stress = assembly.k_matvec_stress(dops, lambda F: linear_stress(F, youngs, poisson), x32)
    torch.cuda.synchronize()
    stress_ms = 1e3 * (time.perf_counter() - t0)
    y_fact = assembly.k_matvec(assembly.build_element_ops(v32, mesh.tets, 2), x32, mu, lam)
    e_stress, e_fact = rel(y_stress, ref), rel(y_fact, ref)
    gate = 4.0 * max(e_fact, 1e-7)
    log(f"leftovers: k_matvec_stress(linear_stress) at order 2 on {3 * mesh.num_vertices} DOF, "
        f"8 columns ({stress_ms:.1f} ms with its DeformOps): card f32 {e_stress:.3e} from the "
        f"CPU's f64 k_matvec in relative norm; the card's f32 k_matvec {e_fact:.3e} (gate "
        f"{gate:.3e})")
    if not e_stress <= gate:
        raise RuntimeError("leftovers: the f32 stress path disagrees with k_matvec")

    # TinyNN's stress path on the card, its gradient, its f64 jacobian
    nn_model = TinyNN(mid_dim=32, stress_scale=1e5, device=dev)
    small = cube_tet_mesh(4, 0.3)
    dsmall = assembly.build_deform_ops(torch.as_tensor(small.vertices, device=dev,
                                                       dtype=torch.float32), small.tets, 1)
    xs = torch.randn(3 * small.num_vertices, 4, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    quad = (xs * assembly.k_matvec_stress(dsmall, nn_model.stress_fn(), xs)).sum()
    grads = torch.autograd.grad(quad, list(nn_model.parameters()))
    C = nn_model.jacobian_F()
    log(f"leftovers: TinyNN stress path on the card: quadratic form {quad.item():.6e}, "
        f"parameter gradient norms {fmt((float(g.norm()) for g in grads), 4)}; jacobian_F "
        f"{tuple(C.shape)} {C.dtype}, norm {float(C.norm()):.6e}")
    if not (torch.isfinite(quad) and all(torch.isfinite(g).all() for g in grads)
            and C.dtype == torch.float64 and torch.isfinite(C).all()):
        raise RuntimeError("leftovers: TinyNN's stress path is not finite")

    # lobpcg_solver_freq on the card (f64) against host ARPACK, on the dense
    # pencil of tests/test_solvers.py's cutoff test at n 300 (a cold LOBPCG
    # from random vectors is for pencils without a rigid null space)
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n = 300
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 400.0, n) ** 2) @ Q.T
    B = np.eye(n) + 0.1 * np.diag(rng.uniform(size=n))
    want, _ = eigsh_shift_invert(sp.csr_matrix(A), sp.csr_matrix(B), k=10, sigma=0.0)
    lim = float(np.sqrt(want[7]) / (2 * np.pi)) * 1.0001
    At, Bt = (torch.as_tensor(m, device=dev) for m in (A, B))
    x0 = torch.as_tensor(rng.standard_normal((n, 10)), device=dev)
    t0 = time.perf_counter()
    vals, vecs = lobpcg_solver_freq(lambda y: At @ y, lambda y: Bt @ y, x0, freq_limit=lim,
                                    rigid_modes=2, max_iters=300, tol=1e-10)
    err = float(np.abs(vals / want[2:8] - 1).max()) if len(vals) == 6 else np.inf
    log(f"leftovers: lobpcg_solver_freq on the card (float64, n {n}) in "
        f"{time.perf_counter() - t0:.3f} s: {len(vals)} modes below {lim:.3f} Hz after the "
        f"2 dropped, max relative error {err:.3e} against host ARPACK (gate 1e-6)")
    if not (vecs.shape == (n, 6) and err <= 1e-6):
        raise RuntimeError("leftovers: lobpcg_solver_freq disagrees with ARPACK")

    # BEM: the analytic pulsating sphere and the far-field decay
    for dtype in (torch.float32, torch.float64):
        a, freq = 0.1, 1000.0
        k = 2 * np.pi * freq / SPEED_OF_SOUND
        verts, faces = icosphere(3, radius=a)
        t0 = time.perf_counter()
        model = BEMModel(verts, faces, freq, device=dev, dtype=dtype)
        model.boundary_equation_solve(1j * 2 * np.pi * freq * AIR_DENSITY * np.ones(len(faces)))
        p = model.potential_solve(np.eye(3))
        torch.cuda.synchronize()
        solve_ms = 1e3 * (time.perf_counter() - t0)
        p = np.abs(p.cpu().numpy())
        exact = AIR_DENSITY * SPEED_OF_SOUND * (k * a / np.sqrt(1 + (k * a) ** 2)) * a
        err, spread = float(np.abs(p / exact - 1).max()), float(np.std(p) / np.mean(p))
        far = BEMModel(*icosphere(2, radius=0.1), 500.0, device=dev, dtype=dtype)
        far.boundary_equation_solve(np.ones(len(far.faces)) * 1j)
        pf = np.abs(far.potential_solve(np.array([[1.0, 0, 0], [2.0, 0, 0]])).cpu().numpy())
        log(f"leftovers: BEM {model._phi.dtype} on the card, {len(faces)} faces, solve and "
            f"potential {solve_ms:.1f} ms: pulsating sphere |p| {fmt(p, 6)} against "
            f"{exact:.6f} ({err:.3e}, gate 0.15; spread {spread:.3e}, gate 0.02); 1/r decay "
            f"ratio {pf[0] / pf[1]:.5f} (2 +- 0.1)")
        if not (err < 0.15 and spread < 0.02 and abs(pf[0] / pf[1] - 2.0) < 0.1):
            raise RuntimeError(f"leftovers: BEM in {model._phi.dtype} fails the analytic checks")


def timed_phase(name, fn):
    """fn(), logging its seconds as phase `name`."""
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from diffsound_torch.audio import synth_kernel

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    synth_kernel.build()
    log(f"kernel build: csrc/synth.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {synth_kernel.BUILD_SECONDS})")

    t_phase = time.perf_counter()
    figures = kernel_phase(device)
    log(f"phase kernel: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    launches, gt_audio = main_path_phase()
    log(f"phase main path: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    reference_phase(gt_audio)
    log(f"phase epoch recipes: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    cli_phase()
    log(f"phase cli: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    real_launches = material_real_phase()
    log(f"phase material_real: {time.perf_counter() - t_phase:.3f} s")
    # the shape and geometry phases spend most of their time in host ARPACK
    # (one core each): the geometry phase runs in a second process beside
    # the shape phase (which runs its two tasks side by side already)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        geometry = pool.submit(timed_phase, "geometry", geometry_phase)
        shape_launches = timed_phase("shape", shape_phase)
        geometry_launches = geometry.result()
    log(f"phases shape and geometry, concurrently: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    leftovers_phase(device)
    log(f"phase leftovers: {time.perf_counter() - t_phase:.3f} s")
    log(f"chip_smoke: {time.perf_counter() - t_start:.3f} s in all")

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "diffsound_torch/csrc/synth.cu",
        "replaces": replaces,
        "launches": launches[name],
        # each path's own count, zeroed just before it and read just after
        "launches_by_path": {"material_sync newton": launches[name],
                             **{f"material_real {k}": v[name]
                                for k, v in real_launches.items()},
                             **{f"shape {k}": v[name] for k, v in shape_launches.items()},
                             "geometry": geometry_launches[name]},
        **figures[name],
        "library_ms": None,
    } for name, replaces in (
        ("synth_constant_modes", "diffsound_tpu/audio/pallas_osc.py:33"),
        # the TPU kernel's VJP: synth_fused's backward recomputes through XLA
        ("synth_constant_modes_bwd", "diffsound_tpu/audio/pallas_osc.py:112"),
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
