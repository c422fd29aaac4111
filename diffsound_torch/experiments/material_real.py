"""Real-audio material inference: a two-stage pipeline.

Counterpart of `diffsound_tpu/experiments/material_real.py`:

  stage 1: fit a fully trainable GT oscillator bank (frequencies, wide-bin
           damping, amplitudes, filtered noise) to the recordings (2001 Adam
           steps on a 5-scale L1), then extract a per-band damping curve
           from the fitted (frequency, damping) pairs;
  stage 2: material inference as in material_sync, synthesizing through
           `OscillatorBank.forward_curve` (damping from the extracted curve)
           against the recordings: a modal-Newton start, a Sinkhorn
           (`geomloss`) early phase, an L1 late phase with the optimizer
           reset at the switch, and a warm eigensolve refresh every 15
           epochs.

Noise streams: stage 1 draws its white noise from a `torch.Generator`, the
JAX package from split PRNG keys, so two stage-1 runs agree across the
packages only in distribution.  `fit_gt_oscillator` takes the noise as a
tensor, or runs without it, to compare step by step.

Run: python -m diffsound_torch.experiments.material_real --config <json>
(add "device": "cpu" to the JSON, or --device cpu, to run on the CPU; the
default is CUDA).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..audio.damping import DampingCurve
from ..audio.freq_loss import extract_spectral_peaks
from ..audio.io import load_real_audio_dir
from ..audio.mss_loss import MSSLoss
from ..audio.oscillator import GTOscillatorBank, OscillatorBank
from ..convert import osc_params_from_jax
from ..fem.material import Material, MatSet, lame_params
from ..fem.mesh import TetMesh
from ..models.modal_fit import ModalNewtonFitter
from ..models.sound_obj import build_model
from ..utils.logging import MetricLogger
from .material_sync import _sync, adam_step_decay, impulse_forces

EIGEN_DECOMPOSE_CYCLE = 15


def fit_gt_oscillator(
    gt_audio,
    forces,
    mode_num: int,
    sample_rate: float,
    mat,
    iters: int = 2001,
    lr: float = 5e-3,
    noise_rate: float = 2e-4,
    non_linear_rate: float = 0.0,
    seed: int = 0,
    verbose: bool = True,
    init_params=None,
    noise=None,
    device="cuda",
):
    """Stage 1: Adam (lr falling by 0.99 every 100 steps) on a 5-scale L1
    between the GT bank's signal and gt_audio (A, T).

    init_params: JAX-style numpy params (see convert.osc_params_from_jax)
    in place of the seeded draw.  The white noise of step i is noise[i]
    when `noise` is given (iters, A, frames, 64), else a fresh draw from a
    generator seeded seed + 1.  non_linear_rate > 0 turns on the
    per-sample nonlinear frequency term.

    Returns (bank, params, losses): the params as detached tensors and the
    loss of every step (numpy)."""
    dev = resolve_device(device)
    dtype = default_dtype(dev)
    gt = torch.as_tensor(gt_audio).to(device=dev, dtype=dtype)
    fz = torch.as_tensor(forces).to(device=dev, dtype=dtype)
    A, T = gt.shape
    bank = GTOscillatorBank(A, mode_num, T, sample_rate, Material.of(mat),
                            use_nonlinear=non_linear_rate > 0.0)
    if init_params is None:
        params = bank.init_params(torch.Generator(device=dev).manual_seed(seed), dtype)
    else:
        params = osc_params_from_jax(init_params, dev, dtype)
    for v in params.values():
        v.requires_grad_(True)
    loss_fn = MSSLoss([512, 256, 128, 64, 32], sample_rate, loss_type="l1_loss")
    with torch.no_grad():
        tc = loss_fn.target_cache(gt)
    opt, sched = adam_step_decay(list(params.values()), lr, 0.99)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    losses = []
    for i in range(iters):
        opt.zero_grad(set_to_none=True)
        sig, _ = bank(params, fz, noise_rate=noise_rate, generator=gen,
                      non_linear_rate=non_linear_rate,
                      noise=None if noise is None else noise[i])
        loss = loss_fn(sig, None, target_cache=tc)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
        if verbose and i % 250 == 0:
            print(f"  pre-osc iter {i}: loss {float(loss.detach()):.5f}")
    losses = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
    return bank, {k: v.detach() for k, v in params.items()}, losses


def extract_damping_curve(bank: GTOscillatorBank, params) -> DampingCurve:
    """The damping curve of a fitted GT bank's (frequency, damping) pairs."""
    with torch.no_grad():
        damps = bank.damping(params).double().cpu().numpy().reshape(-1)
        freqs = bank.freq_linear(params).double().cpu().numpy().reshape(-1)
    return DampingCurve(freqs, damps)


def train_material_real(
    mesh: TetMesh,
    gt_audio,
    damping_curve: DampingCurve,
    init_mat,
    exp_mode: int = 3,
    mode_num: int = 16,
    sample_rate: float = 32000.0,
    force_frame_num: int = 150,
    max_epoch: int = 3000,
    early_loss_epoch: int = 1000,
    logger: MetricLogger = None,
    verbose: bool = True,
    seed: int = 0,
    newton_init: bool = True,
    device="cuda",
) -> dict:
    """Stage 2: recover (E, nu) from the recordings gt_audio (A, T).

    newton_init: start the bins at the closed-form modal-Newton fit
    (models/modal_fit.py) of the recordings' spectral peaks, with the
    damping curve inverting damped to undamped eigenvalues (the pretrained
    start is then skipped: the fit places every logit); else at the init
    table material.  The OscillatorBank's alpha/beta logits are pretrained
    to the table as in the JAX package, although forward_curve does not
    read them.  Eigensolves: host ARPACK cold at epoch 0, a warm LOBPCG
    refresh every 15 epochs, the frequencies from the cached quadratic
    forms; at each the curve's damping at the current frequencies is looked
    up on the host and rounded to float32, as the JAX package passes it.

    Returns E/nu, the log history (every 15 epochs: the step's loss, E, nu
    and the 5-scale RMSE after it), every step's loss, the Newton fit, and
    the wall seconds of the pretraining, the fit, each cold solve and warm
    refresh (with its LOBPCG iterations) and each phase's steps (with the
    RMSE evaluations; synced at every solve and at the phase switch)."""
    dev = resolve_device(device)
    dtype = default_dtype(dev)
    mesh_order = 2 if exp_mode in (1, 3) else 1
    task = "material" if exp_mode in (2, 3) else "mat_baseline"
    audio_np = (gt_audio.detach().cpu().numpy() if torch.is_tensor(gt_audio)
                else np.asarray(gt_audio))
    gt = torch.tensor(audio_np, dtype=dtype, device=dev)
    A, T = gt.shape
    forces = impulse_forces(A, force_frame_num, dtype, dev)
    m = Material.of(init_mat)

    model = build_model(mesh=mesh, mode_num=mode_num, order=mesh_order, mat=m, task=task,
                        dtype=dtype, device=dev)
    osc = OscillatorBank(A, mode_num, T, sample_rate, m)
    t0 = time.perf_counter()
    osc_params = osc.pretrain_damps(
        osc.init_params(torch.Generator(device=dev).manual_seed(seed), dtype))
    _sync(dev)
    pretrain_s = time.perf_counter() - t0

    early_loss = MSSLoss([2048, 1024], sample_rate, loss_type="geomloss")
    late_loss = MSSLoss([1024, 512, 256, 128, 64], sample_rate, loss_type="l1_loss")
    rmse_loss = MSSLoss([1024, 512, 256, 128, 64], sample_rate, loss_type="rmse_loss")
    with torch.no_grad():
        tc = {"early": early_loss.target_cache(gt) if early_loss_epoch > 0 else None,
              "late": late_loss.target_cache(gt), "rmse": rmse_loss.target_cache(gt)}

    params = model.init_params(seed, pretrain=not newton_init)
    fit = None
    t0 = time.perf_counter()
    if newton_init:
        peaks, wts = extract_spectral_peaks(audio_np, sample_rate)
        fitter = ModalNewtonFitter(model, peaks, wts, sample_rate, m.alpha, m.beta,
                                   damping_curve=damping_curve)
        mu0, lam0 = lame_params(m.youngs / m.density, m.poisson)
        fit = fitter.fit(float(mu0), float(lam0), rounds=12, verbose=verbose)
        fit["solves"] = fitter.solves
        if verbose:
            print(f"  newton init: E {fit['E']:.4g} nu {fit['nu']:.4f}")
        params = model.bins.fit_to(params, fit["E"], fit["nu"])
    newton_s = time.perf_counter() - t0
    for v in params.values():
        v.requires_grad_(True)

    def make_opt(epoch):
        lr, gamma = (1e-3, 0.9) if epoch < early_loss_epoch else (2e-3, 0.95)
        return adam_step_decay(list(params.values()), lr, gamma)

    def loss_of(loss_fn, cache, curve_damp, target_cache):
        freqs = model.get_undamped_freqs_cached(params, cache)
        sig, damped = osc.forward_curve(osc_params, freqs, curve_damp, forces)
        return loss_fn(sig, None, damped, 1.0, target_cache=target_cache)

    opt, sched = make_opt(0)
    eig = cache = curve_damp = None
    history, losses = [], []
    cold_s, refresh_s, refresh_iters = [], [], []
    step_s = {"early": 0.0, "late": 0.0}
    t_start = t_chunk = time.perf_counter()

    def close_chunk(epoch):
        """Sync, and book the steps since t_chunk to epoch - 1's phase."""
        _sync(dev)
        now = time.perf_counter()
        if epoch > 0:
            step_s["early" if epoch - 1 < early_loss_epoch else "late"] += now - t_chunk
        return now

    for epoch in range(max_epoch):
        phase = "early" if epoch < early_loss_epoch else "late"
        solve = epoch % EIGEN_DECOMPOSE_CYCLE == 0
        if solve or epoch == early_loss_epoch:
            t_chunk = close_chunk(epoch)
        if solve:
            if eig is None:
                eig = model.eigen_decomposition(params)
                cache = model.modal_cache(eig)
            else:
                eig, cache = model.refresh(params, eig)
                refresh_iters.append(eig.iterations)
            with torch.no_grad():
                f_now = model.get_undamped_freqs_cached(params, cache)
            curve_damp = torch.as_tensor(
                damping_curve(f_now.double().cpu().numpy()).astype(np.float32),
                dtype=dtype, device=dev)
            _sync(dev)
            now = time.perf_counter()
            (refresh_s if refresh_iters else cold_s).append(now - t_chunk)
            t_chunk = now
        if epoch == early_loss_epoch:
            opt, sched = make_opt(epoch)
        opt.zero_grad(set_to_none=True)
        loss = loss_of(early_loss if phase == "early" else late_loss, cache, curve_damp,
                       tc[phase])
        loss.backward()
        model.bins.mask_grads(params)
        opt.step()
        sched.step()
        losses.append(loss.detach())
        if solve:
            with torch.no_grad():
                rec = {
                    "epoch": epoch,
                    "loss": float(loss),
                    "youngs": float(model.bins.youngs(params)),
                    "poisson": float(model.bins.poisson(params)),
                    "rmse": float(loss_of(rmse_loss, cache, curve_damp, tc["rmse"])),
                }
            history.append(rec)
            if logger:
                logger.scalars({k: v for k, v in rec.items() if k != "epoch"}, epoch)
            if verbose:
                print(f"epoch {epoch}: loss {rec['loss']:.5f} rmse {rec['rmse']:.4f} "
                      f"E {rec['youngs']:.4g} nu {rec['poisson']:.4f}")
    end = close_chunk(max_epoch)
    wall = end - t_start
    with torch.no_grad():
        youngs = float(model.bins.youngs(params))
        poisson = float(model.bins.poisson(params))
    return {
        "params": {k: v.detach() for k, v in params.items()},
        "youngs": youngs,
        "poisson": poisson,
        "history": history,
        # the geomloss phase's losses are float64 (see audio/mss_loss.py)
        "losses": (torch.stack([x.double() for x in losses]).cpu().numpy()
                   if losses else np.zeros(0)),
        "newton": fit,
        "eig": eig,
        "wall_s": wall,
        "iters_per_sec": max_epoch / wall if wall > 0 else float("nan"),
        "pretrain_damps_s": pretrain_s,
        "newton_s": newton_s,
        "cold_s": cold_s,
        "refresh_s": refresh_s,
        "refresh_iters": refresh_iters,
        "step_s": step_s,
    }


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags("material_real (diffsound-torch)", argv=argv)
    device = getattr(flags, "device", "cuda")
    resolve_device(device)
    os.makedirs(flags.out_dir, exist_ok=True)
    logger = MetricLogger(flags.out_dir)

    mesh_path = flags.mesh_dir
    mesh = (TetMesh.from_triangle_mesh(mesh_path) if mesh_path.endswith(".obj")
            else TetMesh.from_file(mesh_path))
    mat = Material.of(getattr(MatSet, flags.material))

    gt_audio, _ = load_real_audio_dir(
        flags.audio_dir, flags.sample_rate, flags.frame_num, flags.audio_num
    )
    forces = impulse_forces(len(gt_audio), flags.force_frame_num)

    print("stage 1: GT oscillator fit")
    # stage 1 is thousands of small steps; its (freq, damping) result is
    # cached so that a restarted run goes straight to stage 2
    stage1_cache = os.path.join(flags.out_dir, "stage1_fit.npz")
    if os.path.exists(stage1_cache):
        print(f"  (cached: {stage1_cache})")
        d = np.load(stage1_cache)
        curve = DampingCurve(d["freqs"], d["damps"])
    else:
        bank, pre_params, _ = fit_gt_oscillator(
            gt_audio.astype(np.float32), forces, flags.mode_num * 16, flags.sample_rate, mat,
            iters=getattr(flags, "gt_iters", 2001),
            non_linear_rate=getattr(flags, "non_linear_rate", 0.0),
            device=device,
        )
        curve = extract_damping_curve(bank, pre_params)
        with torch.no_grad():
            freqs = bank.freq_linear(pre_params).cpu().numpy().reshape(-1)
            damps = bank.damping(pre_params).cpu().numpy().reshape(-1)
        np.savez(stage1_cache, freqs=freqs, damps=damps)

    print("stage 2: material inference")
    res = train_material_real(
        mesh, gt_audio, curve, mat,
        exp_mode=flags.exp_mode,
        mode_num=flags.mode_num,
        sample_rate=flags.sample_rate,
        force_frame_num=flags.force_frame_num,
        max_epoch=flags.max_epoch,
        early_loss_epoch=flags.early_loss_epoch,
        logger=logger,
        device=device,
    )
    with open(os.path.join(flags.out_dir, "result.txt"), "a") as f:
        f.write(f"youngs:{res['youngs']}\npoisson:{res['poisson']}\n")
    print(f"recovered E={res['youngs']:.4g} nu={res['poisson']:.4f}")
    return res


if __name__ == "__main__":
    main()
