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
   material_real ground-truth bank (8, 256, 8000) and a ragged T
   (3, 40, 1000), with CUDA-event times of each kernel, of its plain
   version, and of SynthFn's forward and backward against autograd of the
   plain version.
3. Main path at full width: the material_sync L1 trainer
   (`MaterialSyncTask.make_gt` / `.train`) on `cube_tet_mesh(13, 0.3)` at
   order 2 (59,049 DOF), 16 modes, 8000 samples at 32 kHz, flagship pair 0,
   pretrain on, 150 epochs with an eigensolve refresh every 15.  The launch
   counts of both kernels are zeroed just before and read just after; the last
   refresh's eigenvalues are held against a host ARPACK solve, and one
   cached training step in f32 on the card against the port's f64 on the
   CPU at the same params and eigenvectors.  Then a profile of the cached
   training step at that width: host time, device time and kernel launches
   per step.
4. CLI phase: `python -m diffsound_torch.experiments.material_sync`'s
   `main` on a small cube mesh written to a .msh file, 30 epochs.

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


def fmt(xs):
    return " ".join(f"{x:.5f}" for x in xs)


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
    for A, M, T in ((1, 16, 8000), (8, 256, 8000), (3, 40, 1000)):
        f, d, a = synth_modes(A, M, device, seed=A * 1000 + M)
        with torch.no_grad():
            out = synth_kernel.synth_kernel(f, d, a, T, SR)
            ref = synth_constant_modes_plain(f, d, a, T, SR)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        # f32 sum of M terms, each with an f32-rounded phase and envelope
        bound = 1e-5 * a.abs().sum(dim=1, keepdim=True)
        fwd_err = float(err.max())
        if out.shape != (A, T) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"synth kernel ({A},{M},{T}): bad output {tuple(out.shape)}")
        if not bool((err <= bound).all()):
            raise RuntimeError(
                f"synth kernel ({A},{M},{T}): max |kernel - plain| {fwd_err:.3e} "
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
            raise RuntimeError(f"synth backward kernel ({A},{M},{T}): relative errors "
                               f"{bwd_rel} (f, d, amp) against the f64 plain version")
        ins = [x.clone().requires_grad_(True) for x in (f, d, a)]
        g_fn = torch.autograd.grad((SynthFn.apply(*ins, T, SR) * w).sum(), ins)
        if not all(torch.equal(x, y) for x, y in zip(g_fn, g_k)):
            raise RuntimeError(f"SynthFn ({A},{M},{T}): backward differs from the kernel's")

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
        log(f"kernel synth ({A},{M},{T}): max|kernel-plain| {fwd_err:.3e} "
            f"(bound {float(bound.min()):.3e})")
        log(f"kernel synth ({A},{M},{T}): device ms per call, kernel {fmt(fwd['all'])}, "
            f"plain {fmt(fwd_plain['all'])} (three rounds; the plain version launches "
            f"{n_plain} kernels a call); host ms per call, kernel wrapper "
            f"{fwd['host_ms']:.5f}, plain {fwd_plain['host_ms']:.5f}; "
            f"bound {fwd_bound:.7f} ms ({fwd_by})")
        log(f"kernel synth_bwd ({A},{M},{T}): relative error (f, d, amp) against f64 "
            f"{' '.join(f'{x:.3e}' for x in bwd_rel)}, max abs {bwd_abs:.3e}; plain f32 "
            f"{' '.join(f'{x:.3e}' for x in plain_rel)}")
        log(f"kernel synth_bwd ({A},{M},{T}): device ms per call, kernel {fmt(bwd['all'])}, "
            f"plain {fmt(bwd_plain['all'])} (the plain backward launches {n_plain_bwd} "
            f"kernels a call); host ms per call, kernel wrapper {bwd['host_ms']:.5f}, "
            f"plain {bwd_plain['host_ms']:.5f}; bound {bwd_bound:.7f} ms ({bwd_by})")
        log(f"SynthFn forward+backward ({A},{M},{T}): device ms per call {fmt(fn['all'])}, "
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


def main_path_phase():
    """The material_sync trainer at full width; returns the launch counts."""
    import numpy as np
    import torch

    from diffsound_torch.audio import synth_kernel
    from diffsound_torch.experiments.material_sync import (
        MaterialSyncTask, flagship_material_pairs,
    )
    from diffsound_torch.fem.mesh import cube_tet_mesh
    from diffsound_torch.models.sound_obj import build_model

    mesh = cube_tet_mesh(13, 0.3)
    init_mat, gt_mat = flagship_material_pairs(1)[0]
    task = MaterialSyncTask(mesh=mesh, mode_num=16, sample_rate=SR, frame_num=8000,
                            force_frame_num=150, exp_mode=3)
    epochs = 150

    synth_kernel.LAUNCHES = synth_kernel.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    gt_audio, gt_freqs = task.make_gt(gt_mat)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    res = task.train(init_mat, gt_audio, max_epoch=epochs, early_loss_epoch=0,
                     late_freq_weight=0.0, pretrain=True, verbose=True)
    torch.cuda.synchronize()
    launches = {"synth_constant_modes": synth_kernel.LAUNCHES,
                "synth_constant_modes_bwd": synth_kernel.LAUNCHES_BWD}

    eig = res["eig"]
    dof = eig.eigenvectors.shape[0]
    losses = res["losses"]
    refresh_s, iters = np.asarray(res["refresh_s"]), np.asarray(res["refresh_iters"])
    step_ms = 1e3 * res["step_s"] / epochs
    log(f"main path: {dof} DOF, ground truth (order-2 model + ARPACK + synth) {gt_s:.3f} s")
    log(f"main path: cold ARPACK solve + modal cache {res['cold_s'][0]:.3f} s; "
        f"{len(refresh_s)} warm refreshes, mean {1e3 * refresh_s.mean():.2f} ms, "
        f"LOBPCG iterations {iters.tolist()}")
    log(f"main path: {epochs} steps, mean step {step_ms:.3f} ms, "
        f"{res['iters_per_sec']:.3f} iters/s over {res['wall_s']:.3f} s of training")
    log(f"main path: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"E {res['youngs']:.6g} (target {gt_mat[1]:.6g}, init {init_mat[1]:.6g}), "
        f"nu {res['poisson']:.5f} (target {gt_mat[2]:.5f}, init {init_mat[2]:.5f})")
    log(f"main path: synth kernel launches {launches['synth_constant_modes']}, "
        f"synth backward kernel launches {launches['synth_constant_modes_bwd']}")

    if dof != 59049:
        raise RuntimeError(f"expected 59,049 DOF, got {dof}")
    if not (np.isfinite(losses).all() and len(losses) == epochs):
        raise RuntimeError("non-finite or missing losses")
    if not losses[-15:].mean() < losses[:15].mean():
        raise RuntimeError(
            f"loss did not fall: first 15 mean {losses[:15].mean():.5f}, "
            f"last 15 mean {losses[-15:].mean():.5f}")
    for name, n in launches.items():
        if n < epochs:
            raise RuntimeError(f"the main path launched {name} {n} times, fewer than "
                               f"its {epochs} steps")

    # the last warm refresh's eigenvalues against host ARPACK at its material
    mu, lam = res["refresh_lame"][-1]
    check = build_model(mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material")
    t0 = time.perf_counter()
    ref = check.eigen_decomposition_at_lame(mu, lam)
    arpack_s = time.perf_counter() - t0
    got = eig.eigenvalues[6:].double().cpu().numpy()
    want = ref.eigenvalues[6:].double().cpu().numpy()
    rel = float(np.abs(got / want - 1.0).max())
    log(f"main path: last refresh vs host ARPACK ({arpack_s:.3f} s): "
        f"max relative eigenvalue error {rel:.3e} over 16 modes")
    if not rel <= 1e-3:
        raise RuntimeError(f"refresh eigenvalues off ARPACK by {rel:.3e} (> 1e-3)")

    step_precision_check(check, mesh, init_mat, eig, res["params"], gt_audio)
    step_profile(check, check.modal_cache(eig), res["params"], gt_audio, init_mat)
    return launches


def step_inputs(init_mat, gt_audio, dtype):
    """The trainer's oscillator bank, impulse force, 5-scale L1 loss and
    target cache, at the main path's width."""
    from diffsound_torch.audio.mss_loss import MSSLoss
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.experiments.material_sync import impulse_forces
    from diffsound_torch.fem.material import Material

    osc = TraditionalOscillatorParams(1, 16, 8000, SR, Material.of(init_mat))
    forces = impulse_forces(1, 150, dtype, gt_audio.device)
    loss_fn = MSSLoss([1024, 512, 256, 128, 64], SR, loss_type="l1_loss")
    return osc, forces, loss_fn, loss_fn.target_cache(gt_audio.to(dtype))


def step_precision_check(model, mesh, init_mat, eig, params, gt_audio):
    """One cached training step on the card in f32 (bmm modal cache,
    synthesis kernel, cuFFT loss, autograd, Adam) against the port's f64 on
    the CPU, at the same params and the same eigenvectors; the port's f32 on
    the CPU runs beside them as the witness of what f32 alone costs.

    Gates, the card's f32 against the f64: corrected frequencies within
    1e-4 and the loss within 1e-5 relative; each tensor of the loss's
    gradient at cosine >= 0.999; one Adam step from a fresh state moves
    every parameter within 1e-3 lr of the f64 step.  The relative norm
    errors of the loss's gradient and of a smooth probe's, <signal,
    target>, are only held under 0.5, which catches a wrong sign or
    factor: in f32 they are loose on any device, because the gradient sums
    8000 samples of oscillating terms that mostly cancel, and the
    log-spectrogram passes through d log(S)/dS = 1/S for every bin, where
    the bins on the noise floor hold rounding.  That error scales dL/dE and
    dL/dnu as a whole, and Adam divides each parameter's step by its own
    gradient scale, so the step does not see it."""
    import torch

    from diffsound_torch.experiments.material_sync import adam_step_decay
    from diffsound_torch.models.sound_obj import EigenState, build_model

    lr = 2e-3
    runs = {}
    for name, device, dtype in (("card f32", model.device, torch.float32),
                                ("cpu f32", torch.device("cpu"), torch.float32),
                                ("cpu f64", torch.device("cpu"), torch.float64)):
        m = model if name == "card f32" else build_model(
            mesh=mesh, mode_num=16, order=2, mat=init_mat, task="material",
            dtype=dtype, device=device)
        e = EigenState(*(t.to(device=device, dtype=dtype) for t in
                         (eig.eigenvalues, eig.eigenvectors)), eig.iterations,
                       eig.residual.to(device=device, dtype=dtype))
        p = {k: v.detach().to(device).clone().requires_grad_(True)
             for k, v in params.items()}
        keys = list(p)
        osc, forces, loss_fn, tc = step_inputs(init_mat, gt_audio.to(device), dtype)
        freqs = m.get_undamped_freqs_cached(p, m.modal_cache(e))
        sig, damped = osc(freqs, forces, dtype=dtype)
        probe = (sig * gt_audio.to(device=device, dtype=dtype)).sum()
        g_probe = torch.autograd.grad(probe, [p[k] for k in keys], retain_graph=True)
        loss = loss_fn(sig, None, damped, 1.0, target_cache=tc)
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

    ref = runs["cpu f64"]
    errs = {}
    for name in ("card f32", "cpu f32"):
        r = runs[name]
        errs[name] = dict(
            freqs=float(((r["freqs"] - ref["freqs"]).abs() / ref["freqs"]).max()),
            loss=abs(r["loss"] / ref["loss"] - 1),
            probe=rel(r["probe"], ref["probe"]),
            grad=rel(r["grad"], ref["grad"]),
            cos=min(float((a * b).sum() / (a.norm() * b.norm()))
                    for a, b in zip(r["grad"], ref["grad"])),
            step=max(float((a - b).abs().max()) for a, b in zip(r["step"], ref["step"])) / lr,
        )
        x = errs[name]
        log(f"step precision, {name} against cpu f64 at the last refresh's eigenvectors: "
            f"frequencies {x['freqs']:.3e}, loss {r['loss']:.6f} vs {ref['loss']:.6f} "
            f"({x['loss']:.3e}), loss gradient {x['grad']:.3e} in relative norm at cosine "
            f"{x['cos']:.9f}, probe gradient {x['probe']:.3e}, Adam step {x['step']:.3e} lr")
    card = errs["card f32"]
    if not (card["freqs"] <= 1e-4 and card["loss"] <= 1e-5 and card["cos"] >= 0.999
            and card["step"] <= 1e-3 and card["grad"] <= 0.5 and card["probe"] <= 0.5):
        raise RuntimeError("the f32 cached step on the card disagrees with the CPU f64 step "
                           "beyond its gates (see the docstring of step_precision_check)")


def step_profile(model, cache, params, gt_audio, init_mat, steps: int = 30):
    """Where a cached training step's time goes, at the main path's width:
    the host's wall time per step, and from torch.profiler the kernels
    launched per step and the device time they take.  The step is the
    trainer's: cached frequencies, synthesis, force convolution, 5-scale
    L1, backward, Adam."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    osc, forces, loss_fn, tc = step_inputs(init_mat, gt_audio, torch.float32)
    opt = torch.optim.Adam(list(params.values()), lr=2e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        sig, damped = osc(model.get_undamped_freqs_cached(params, cache), forces)
        loss_fn(sig, None, damped, 1.0, target_cache=tc).backward()
        model.bins.mask_grads(params)
        opt.step()

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    device_work = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device_work) / 5
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel") / 5
    kernels = sum(1 for e in device_work if not e.name.startswith(("Memcpy", "Memset"))) / 5
    log(f"step profile: host {host_ms:.3f} ms per step, device work {device_ms:.3f} ms "
        f"(idle share {1 - device_ms / host_ms:.3f}), {launches:.0f} cudaLaunchKernel "
        f"calls, {kernels:.0f} kernels and {len(device_work) / 5:.0f} device activities "
        f"per step")
    if not 0 < device_ms < host_ms:
        raise RuntimeError(f"step profile: device work {device_ms:.3f} ms per step "
                           f"against {host_ms:.3f} ms of host time")


def cli_phase():
    """material_sync's CLI main on a small cube mesh."""
    from diffsound_torch.audio import synth_kernel
    from diffsound_torch.experiments import material_sync
    from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        mesh = cube_tet_mesh(4)
        msh = os.path.join(tmp, "cube.msh")
        write_msh(msh, mesh.vertices, mesh.tets)
        out_dir = os.path.join(tmp, "out")
        cfg = {
            "sample_rate": 32000, "frame_num": 8000, "force_frame_num": 150,
            "mesh_dir": msh, "mesh_name": "cube", "mode_num": 16, "max_epoch": 30,
            "early_loss_epoch": 0, "late_freq_weight": 0, "recipe": "adam",
            "num_material_pairs": 1, "exp_mode": 3, "out_dir": out_dir,
        }
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        synth_kernel.LAUNCHES = synth_kernel.LAUNCHES_BWD = 0
        material_sync.main(["--config", cfg_path])
        launches, launches_bwd = synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD
        with open(os.path.join(out_dir, "result.txt")) as f:
            fields = dict(line.strip().split(":", 1) for line in f if ":" in line)
    youngs, poisson = float(fields["youngs"]), float(fields["poisson"])
    log(f"cli: result.txt E {youngs:.6g} nu {poisson:.5f}; synth kernel launches "
        f"{launches}, backward {launches_bwd}")
    if not (math.isfinite(youngs) and math.isfinite(poisson)):
        raise RuntimeError("result.txt holds non-finite E or nu")
    if min(launches, launches_bwd) < 30:
        raise RuntimeError(f"the CLI run launched the synth kernels {launches} and "
                           f"{launches_bwd} times")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from diffsound_torch.audio import synth_kernel

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
    launches = main_path_phase()
    log(f"phase main path: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    cli_phase()
    log(f"phase cli: {time.perf_counter() - t_phase:.3f} s")

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "diffsound_torch/csrc/synth.cu",
        "replaces": replaces,
        "launches": launches[name],
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
