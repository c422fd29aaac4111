"""Synthetic-material inference: recover (E, nu) from modal audio.

Counterpart of `diffsound_tpu/experiments/material_sync.py`: ground-truth
audio from an order-2 fixed-material model and a fixed-table oscillator;
the trainable model's material is then recovered by one of three recipes:

  * `newton` (the CLI's default): the closed-form modal-Newton fit
    (models/modal_fit.py) on spectral peaks of the target, arbitrated over
    three peak-extraction windows by union coverage, then a short polish
    with the multi-scale L1 loss plus the freq-chamfer auxiliary;
  * `adam`: the epoch trainer with a freq-chamfer early phase
    (audio/freq_loss.py) and the multi-scale L1 late phase with the
    freq-chamfer auxiliary;
  * `reference`: the epoch trainer with the Sinkhorn early phase
    (`geomloss`, audio/sinkhorn.py) and the plain multi-scale L1 late phase.

The epoch trainer runs Adam with a step-decayed learning rate, reset at the
switch from the early to the late phase, and a warm LOBPCG eigensolve
refresh every 15 epochs.  The `parallel` recipe (`train_pairs_parallel`)
trains every pair at once with the multi-pair trainer of parallel/: on one
card in one process (dp = ep = 1), or over the ranks of a torch.distributed
world (launched with torchrun; gloo on the CPU, NCCL on CUDA).

exp_mode: 0 ord1/frozen-nu (baseline), 1 ord2/frozen-nu, 2 ord1/learn-nu,
3 ord2/learn-nu (full DiffSound).

Run: python -m diffsound_torch.experiments.material_sync --config <json>
(add "device": "cpu" to the JSON to run on the CPU; the default is CUDA).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..audio.freq_loss import (
    extract_spectral_peaks, freq_chamfer_loss, peak_coverage_score, union_peaks,
)
from ..audio.mss_loss import MSSLoss
from ..audio.oscillator import TraditionalOscillatorParams
from ..convert import params_from_jax
from ..fem.material import Material, MatSet, lame_params
from ..fem.mesh import TetMesh
from ..models.modal_fit import ModalNewtonFitter
from ..models.sound_obj import build_model
from ..solvers.diff_eigs import undamped_frequencies
from ..utils import prng
from ..utils.logging import MetricLogger

EIGEN_DECOMPOSE_CYCLE = 15
EARLY_LOSS_TYPES = ("freq_chamfer", "geomloss")
RECIPES = ("newton", "adam", "reference")

def random_material_pairs(key, n: int = 16):
    """n random (init, target) materials within [RandomMin, RandomMax]
    (material_sync_train.py:72-89), drawn from the uint32[2] key `key`
    exactly as the JAX package's random_material_pairs draws them."""
    lo, hi = MatSet.RandomMin, MatSet.RandomMax
    ks = prng.split(key, 4)
    draw = lambda k, a, b: prng.uniform(k, (n,)) * (b - a) + a
    init_y, tgt_y = draw(ks[0], lo[1], hi[1]), draw(ks[1], lo[1], hi[1])
    init_p, tgt_p = draw(ks[2], lo[2], hi[2]), draw(ks[3], lo[2], hi[2])
    pairs = []
    for i in range(n):
        init, tgt = list(lo), list(lo)
        init[1], init[2] = float(init_y[i]), float(init_p[i])
        tgt[1], tgt[2] = float(tgt_y[i]), float(tgt_p[i])
        pairs.append((tuple(init), tuple(tgt)))
    return pairs


def flagship_material_pairs(n: int = 16):
    """The first n flagship (init, target) pairs: the draw from key 0, which
    the CLI trains (the draws are prefix-stable: the first n of a longer
    draw are these)."""
    return random_material_pairs(prng.PRNGKey(0), n)


def impulse_forces(audio_num: int, force_frame_num: int, dtype=torch.float32, device="cpu"):
    f = torch.zeros((audio_num, force_frame_num), dtype=dtype, device=device)
    f[:, 0] = 1.0
    return f


def adam_step_decay(params, lr: float, gamma: float):
    """Adam whose learning rate falls by `gamma` every 100 steps: the
    counterpart of optax.adam(optax.exponential_decay(lr, 100, gamma,
    staircase=True)).  Returns (optimizer, scheduler); step both each step."""
    opt = torch.optim.Adam(params, lr=lr)
    return opt, torch.optim.lr_scheduler.StepLR(opt, step_size=100, gamma=gamma)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class MaterialSyncTask:
    mesh: TetMesh
    mode_num: int = 16
    sample_rate: float = 32000.0
    frame_num: int = 8000
    force_frame_num: int = 150
    exp_mode: int = 3
    dtype: Optional[torch.dtype] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        self.mesh_order = 2 if self.exp_mode in (1, 3) else 1
        self.task = "material" if self.exp_mode in (2, 3) else "mat_baseline"

    def _build(self, mat, order, task):
        return build_model(
            mesh=self.mesh, mode_num=self.mode_num, order=order, mat=mat,
            task=task, dtype=self.dtype, device=self.device,
        )

    # -- ground truth -------------------------------------------------------

    def _dump_media(self, media_dir, epoch, model, osc, params, cache,
                    gt_audio, forces, logger=None, n_fft: int = 512):
        """Per-log-cycle observability: side-by-side log-spectrogram figure
        and predicted/gt wav files."""
        from ..audio.io import write_wav
        from ..audio.stft import spectrogram
        from ..utils.visualize import save_spec_figure

        os.makedirs(media_dir, exist_ok=True)
        with torch.no_grad():
            freqs = model.get_undamped_freqs_cached(params, cache)
            sig, _ = osc(freqs, forces, dtype=self.dtype)
            pred, gt = sig[0], gt_audio[0].to(sig.dtype)
            sp = torch.log(spectrogram(pred, n_fft, n_fft // 4) + 1e-7).cpu().numpy()
            sg = torch.log(spectrogram(gt, n_fft, n_fft // 4) + 1e-7).cpu().numpy()
        pred, gt = pred.cpu().numpy(), gt.cpu().numpy()
        fig_path = os.path.join(media_dir, f"spec_{epoch:06d}.png")
        save_spec_figure(fig_path, sg, sp)
        scale = max(np.abs(pred).max(), np.abs(gt).max(), 1e-9)
        write_wav(os.path.join(media_dir, f"pred_{epoch:06d}.wav"),
                  pred / scale, int(self.sample_rate))
        if epoch == 0:
            write_wav(os.path.join(media_dir, "gt.wav"), gt / scale,
                      int(self.sample_rate))
        if logger is not None and hasattr(logger, "figure"):
            logger.figure("spec", fig_path, epoch)

    def make_gt(self, gt_mat) -> tuple:
        """Ground-truth audio (1, frame_num) from an order-2 fixed-material
        model, and its undamped frequencies (numpy)."""
        gt_model = self._build(gt_mat, 2, "gt")
        eig = gt_model.eigen_decomposition()
        with torch.no_grad():
            freqs = gt_model.get_undamped_freqs({}, eig)
            gt_osc = TraditionalOscillatorParams(
                1, self.mode_num, self.frame_num, self.sample_rate, Material.of(gt_mat)
            )
            forces = impulse_forces(1, self.force_frame_num, self.dtype, self.device)
            gt_audio, _ = gt_osc(freqs, forces, dtype=self.dtype)
        return gt_audio, freqs.cpu().numpy()

    # -- training -----------------------------------------------------------

    def train(
        self,
        init_mat,
        gt_audio,
        max_epoch: int = 3000,
        early_loss_epoch: int = 1000,
        logger: MetricLogger = None,
        log_every: int = EIGEN_DECOMPOSE_CYCLE,
        seed: int = 0,
        pretrain: bool = True,
        verbose: bool = True,
        lr_early: float = 5e-3,
        lr_late: float = 2e-3,
        checkpoint_dir: str = None,
        checkpoint_every: int = 1500,
        media_dir: str = None,
        media_every: int = 300,
        early_loss_type: str = "freq_chamfer",
        late_freq_weight: float = 300.0,
        init_values=None,
        init_logits: Optional[dict] = None,
    ) -> dict:
        """Train the material bins against `gt_audio` (A, T).

        Epochs before early_loss_epoch use the early loss, the rest the
        5-scale L1, with the optimizer reset to (lr_late, 0.95) at the
        switch.  early_loss_type: 'freq_chamfer' (default; spectral-peak
        matching with no synthesis, audio/freq_loss.py) or 'geomloss' (the
        reference's Sinkhorn recipe on MSSLoss([2048, 1024])).
        late_freq_weight: weight of the freq-chamfer auxiliary added to the
        late L1 (freq_chamfer only; 0 disables).

        The start: the seeded random logits, pretrained to the init table
        material when `pretrain` and no init_values; init_values (E, nu)
        places them exactly there (the modal-Newton handoff); init_logits,
        a dict of numpy logits, replaces the random draw (to start from
        exactly the JAX package's draw).

        Returns recovered E/nu, the loss per epoch, the log history, and the
        timing: wall seconds of each cold solve (host ARPACK plus the modal
        cache) with its Lame values, of each warm refresh with its LOBPCG
        iterations and Lame values, and of all steps, with a device sync at
        each solve and at the end of each chunk of steps; `cold_eig` is the
        last cold solve's EigenState."""
        if early_loss_type not in EARLY_LOSS_TYPES:
            raise ValueError(f"early_loss_type must be one of {EARLY_LOSS_TYPES}, "
                             f"got {early_loss_type!r}")
        dev = self.device
        model = self._build(init_mat, self.mesh_order, self.task)
        gt_audio = gt_audio.to(device=dev, dtype=self.dtype)
        osc = TraditionalOscillatorParams(
            gt_audio.shape[0], self.mode_num, self.frame_num, self.sample_rate,
            Material.of(init_mat),
        )
        forces = impulse_forces(gt_audio.shape[0], self.force_frame_num, self.dtype, dev)
        early_loss = MSSLoss([2048, 1024], self.sample_rate, loss_type="geomloss")
        late_loss = MSSLoss([1024, 512, 256, 128, 64], self.sample_rate, loss_type="l1_loss")
        rmse_loss = MSSLoss([1024, 512, 256, 128, 64], self.sample_rate, loss_type="rmse_loss")
        chamfer = early_loss_type == "freq_chamfer"
        if chamfer:
            pk, pw = extract_spectral_peaks(gt_audio.cpu().numpy(), self.sample_rate)
            peaks, wts = (torch.as_tensor(x, dtype=self.dtype, device=dev) for x in (pk, pw))

        if init_logits is None:
            params = model.init_params(seed, pretrain=False)
        else:
            params = params_from_jax(init_logits, dev)
        if init_values is not None:
            params = model.bins.fit_to(params, *init_values)
        elif pretrain:
            params = model.bins.pretrain(params)
        for v in params.values():
            v.requires_grad_(True)

        def make_opt(lr, gamma):
            return adam_step_decay(list(params.values()), lr, gamma)

        def phase_opt(epoch):
            return make_opt(lr_early, 0.9) if epoch < early_loss_epoch else make_opt(lr_late, 0.95)

        with torch.no_grad():
            tc_early = None if chamfer else early_loss.target_cache(gt_audio)
            tc_late = late_loss.target_cache(gt_audio)
            tc_rmse = rmse_loss.target_cache(gt_audio)

        def loss_with(loss_fn, cache, tc):
            freqs = model.get_undamped_freqs_cached(params, cache)
            sig, damped = osc(freqs, forces, dtype=self.dtype)
            return loss_fn(sig, None, damped, 1.0, target_cache=tc)

        def chamfer_of(cache):
            freqs = model.get_undamped_freqs_cached(params, cache)
            return freq_chamfer_loss(freqs, peaks, wts, self.sample_rate)

        def early_loss_fn(cache):
            if chamfer:
                # pure frequency matching: no synthesis, no STFT
                return chamfer_of(cache)
            return loss_with(early_loss, cache, tc_early)

        def late_loss_fn(cache):
            l1 = loss_with(late_loss, cache, tc_late)
            if chamfer and late_freq_weight > 0:
                return l1 + late_freq_weight * chamfer_of(cache)
            return l1

        opt, sched = phase_opt(0)
        ckpt = None
        start_epoch = 0
        if checkpoint_dir is not None:
            from ..utils.checkpoint import TrainCheckpointer

            ckpt = TrainCheckpointer(checkpoint_dir, every=checkpoint_every)
            state = ckpt.load(dev)
            if state is not None:
                with torch.no_grad():
                    for k, v in params.items():
                        v.copy_(state["params"][k])
                start_epoch = state["step"]
                opt, sched = phase_opt(start_epoch)
                opt.load_state_dict(state["optimizer"])
                sched.load_state_dict(state["scheduler"])
                print(f"resumed from checkpoint at epoch {start_epoch}")

        eig = cache = None
        history, losses = [], []
        cold_s, cold_lame, refresh_s, refresh_iters, refresh_lame = [], [], [], [], []
        cold_eig = None
        step_s = 0.0
        t_start = time.perf_counter()

        def next_boundary(e):
            """First epoch > e where host work is due (refresh / phase
            switch / logging / checkpoint / end)."""
            cands = [max_epoch]
            for period in (EIGEN_DECOMPOSE_CYCLE, log_every):
                cands.append((e // period + 1) * period)
            if ckpt is not None:
                cands.append((e // checkpoint_every + 1) * checkpoint_every)
            if e < early_loss_epoch:
                cands.append(early_loss_epoch)
            return min(c for c in cands if c > e)

        epoch = start_epoch
        while epoch < max_epoch:
            if epoch % EIGEN_DECOMPOSE_CYCLE == 0 or eig is None:
                t0 = time.perf_counter()
                warm = eig is not None
                if warm:
                    eig, cache = model.refresh(params, eig)
                else:
                    eig = model.eigen_decomposition(params)
                    cache = model.modal_cache(eig)
                _sync(dev)
                if warm:
                    refresh_s.append(time.perf_counter() - t0)
                    refresh_iters.append(eig.iterations)
                    refresh_lame.append(model.material_lame_floats(params))
                else:
                    cold_s.append(time.perf_counter() - t0)
                    cold_lame.append(model.material_lame_floats(params))
                    cold_eig = eig
            if epoch == early_loss_epoch:
                opt, sched = make_opt(lr_late, 0.95)
            log_this = epoch % log_every == 0
            log_epoch = epoch
            n = next_boundary(epoch) - epoch
            step_loss = early_loss_fn if epoch < early_loss_epoch else late_loss_fn
            t0 = time.perf_counter()
            chunk = []
            for _ in range(n):
                opt.zero_grad(set_to_none=True)
                loss = step_loss(cache)
                loss.backward()
                model.bins.mask_grads(params)
                opt.step()
                sched.step()
                chunk.append(loss.detach())
            losses.extend(chunk)
            _sync(dev)
            step_s += time.perf_counter() - t0
            epoch += n

            if ckpt is not None:
                # `epoch` is now the count of completed epochs; a restore
                # resumes at exactly this epoch with no step re-run.
                ckpt.maybe_save(epoch, params, opt, sched)
            if log_this:
                with torch.no_grad():
                    youngs = float(model.bins.youngs(params))
                    poisson = float(model.bins.poisson(params))
                    rmse = float(loss_with(rmse_loss, cache, tc_rmse))
                rec = {
                    "loss": float(chunk[0]), "rmse": rmse, "youngs": youngs,
                    "poisson": poisson, "epoch": log_epoch,
                }
                history.append(rec)
                if logger:
                    logger.scalars(
                        {k: v for k, v in rec.items() if k != "epoch"}, log_epoch
                    )
                if verbose:
                    print(
                        f"epoch {log_epoch}: loss {rec['loss']:.5f} "
                        f"rmse {rmse:.4f} E {youngs:.4g} nu {poisson:.4f}"
                    )
                if media_dir is not None and log_epoch % media_every == 0:
                    self._dump_media(
                        media_dir, log_epoch, model, osc, params, cache,
                        gt_audio, forces, logger,
                    )
        wall = time.perf_counter() - t_start
        n_steps = max_epoch - start_epoch

        with torch.no_grad():
            rmse = float(loss_with(rmse_loss, cache, tc_rmse))
            youngs = float(model.bins.youngs(params))
            poisson = float(model.bins.poisson(params))
        return {
            "params": {k: v.detach() for k, v in params.items()},
            "youngs": youngs,
            "poisson": poisson,
            "rmse": rmse,
            "history": history,
            # the geomloss phase's losses are float64 (see audio/mss_loss.py)
            "losses": (torch.stack([x.double() for x in losses]).cpu().numpy()
                       if losses else np.zeros(0)),
            "wall_s": wall,
            "iters_per_sec": n_steps / wall,
            "eig": eig,
            "cold_s": cold_s,
            "cold_lame": cold_lame,
            "cold_eig": cold_eig,
            "refresh_s": refresh_s,
            "refresh_iters": refresh_iters,
            "refresh_lame": refresh_lame,
            "step_s": step_s,
        }

    def train_newton(
        self,
        init_mat,
        gt_audio,
        rounds: int = 20,
        polish_epochs: int = 300,
        logger: MetricLogger = None,
        seed: int = 0,
        verbose: bool = True,
        extraction_windows=(("hann", 4096), ("blackmanharris", 4096),
                            ("blackmanharris", None)),
        **train_kw,
    ) -> dict:
        """Closed-form modal-Newton material fit (models/modal_fit.py),
        then an optional short polish: `train` from the fitted (E, nu) with
        no early phase, for polish_epochs.

        extraction_windows: peak-extraction scheme candidates, each a
        (window, n_fft) pair (n_fft None: one whole-signal window).  Every scheme's peak set
        is fit on its own, the eigenstate carried from one scheme's fit to
        the next as a warm start, and the union-coverage score
        (audio.freq_loss.peak_coverage_score against the merged peak set of
        all schemes) picks the fit: no single scheme works for all 16
        flagship pairs, and neither the fit's own match weight nor the
        smooth chamfer can arbitrate between them.

        The result has the polish's keys (see `train`) and fit_rounds,
        newton_E, newton_nu; `fit` holds the fit's wall seconds, its
        eigensolves (ModalNewtonFitter.solves: warm or cold, LOBPCG
        iterations, seconds) and each window's E, nu and coverage score."""
        t0 = time.perf_counter()
        model = self._build(init_mat, self.mesh_order, self.task)
        mu0, lam0 = lame_params(init_mat[1] / init_mat[0], init_mat[2])

        schemes = [tuple(w) for w in extraction_windows]
        audio = gt_audio.cpu().numpy()
        peak_sets = [
            extract_spectral_peaks(audio, self.sample_rate, n_fft=nfft, window=win)
            for win, nfft in schemes
        ]
        union_f, union_w = union_peaks(peak_sets)
        fit = None
        eig_carry = None
        solves, windows = [], []
        for (win, nfft), (peaks, wts) in zip(schemes, peak_sets):
            fitter = ModalNewtonFitter(
                model, peaks, wts, self.sample_rate, init_mat[3], init_mat[4]
            )
            cand = fitter.fit(float(mu0), float(lam0), rounds=rounds,
                              verbose=verbose, eig=eig_carry)
            solves.extend(fitter.solves)
            eig_carry = cand["eig"]  # warm-start the next candidate
            with torch.no_grad():
                cache = model.modal_cache(cand["eig"])
                lams = (
                    cache.eigenvalues + cand["mu"] * cache.q_mu + cand["lam"] * cache.q_lam
                    - cache.eigenvalues * cache.q_m
                )[model.extra_modes:]
                freqs = undamped_frequencies(lams.float()).cpu().numpy()
            cand["score"] = peak_coverage_score(
                freqs, union_f, union_w, self.sample_rate
            )
            windows.append({"window": win, "n_fft": nfft, "E": cand["E"],
                            "nu": cand["nu"], "score": cand["score"],
                            "rounds": len(cand["history"])})
            if verbose:
                print(f"  window {win}@{nfft}: E {cand['E']:.4g} nu "
                      f"{cand['nu']:.4f} union coverage "
                      f"{cand['score']:.4f}")
            if fit is None or cand["score"] > fit["score"]:
                fit = cand
        fit_wall = time.perf_counter() - t0
        fit_info = {"wall_s": fit_wall, "solves": solves, "windows": windows}
        if logger:
            for rec in fit["history"]:
                logger.scalars(
                    {"newton_E": rec["E"], "newton_nu": rec["nu"]}, rec["round"],
                )
        if polish_epochs <= 0:
            return {
                "youngs": fit["E"], "poisson": fit["nu"],
                "rmse": float("nan"), "history": fit["history"],
                "wall_s": fit_wall,
                "iters_per_sec": len(fit["history"]) / fit_wall,
                "fit_rounds": len(fit["history"]),
                "newton_E": fit["E"], "newton_nu": fit["nu"], "fit": fit_info,
            }
        res = self.train(
            init_mat, gt_audio, max_epoch=polish_epochs,
            early_loss_epoch=0, logger=logger, seed=seed, verbose=verbose,
            init_values=(fit["E"], fit["nu"]), pretrain=False,
            **train_kw,
        )
        res["fit_rounds"] = len(fit["history"])
        res["newton_E"], res["newton_nu"] = fit["E"], fit["nu"]
        res["fit"] = fit_info
        res["wall_s"] += fit_wall
        res["iters_per_sec"] = polish_epochs / res["wall_s"]
        return res


def train_pairs_parallel(task: MaterialSyncTask, pairs, flags, logger=None,
                         init_logits: Optional[dict] = None,
                         gt_audio: Optional[torch.Tensor] = None) -> dict:
    """Train all material pairs at once on a (dp, ep) mesh over this
    process's torch.distributed world (one process: dp = ep = 1), with the
    JAX package's rule ep = 2 from 4 ranks on.  Every pair starts from the
    same bins, pretrained to pair 0's init material (`init_logits`, numpy
    (B, K) logits such as the JAX package's `MultipairTrainer.init`,
    replace them), and the cold basis at that material; flags.max_epoch
    L1 steps at lr 2e-3 with a warm refresh every 15.  gt_audio (B, T), the
    pairs' ground truths, is made with task.make_gt when None.

    Returns all pairs' youngs and poisson (B,), pair_iters_per_sec, the
    losses per step (max_epoch, B), and this rank's final state and timing:
    params, eigval, eigvec, gt (device tensors of its pairs), the trainer,
    the cold solve (cold_eig) and its seconds, each refresh's seconds and
    LOBPCG iterations per pair, and the steps' seconds (device synced at
    each refresh and at the end)."""
    from ..convert import params_from_jax
    from ..parallel.mesh import make_device_mesh, world
    from ..parallel.train import MultipairTrainer

    _, n = world()
    ep = 2 if n >= 4 else 1
    dmesh = make_device_mesh(dp=max(n // ep, 1), ep=ep, device=task.device)
    dev = dmesh.device
    B = len(pairs)
    sl = dmesh.pair_slice(B)

    init_mat = pairs[0][0]
    model = task._build(init_mat, task.mesh_order, task.task)
    osc = TraditionalOscillatorParams(1, task.mode_num, task.frame_num, task.sample_rate,
                                      Material.of(init_mat))
    forces = impulse_forces(1, task.force_frame_num, task.dtype, dev)
    trainer = MultipairTrainer(bins=model.bins, ops=model.ops, osc=osc, mesh=dmesh,
                               forces=forces, sample_rate=task.sample_rate, lr=2e-3)
    if gt_audio is None:  # this rank's pairs only
        gt_b = torch.cat([task.make_gt(g)[0] for _, g in pairs[sl]]).to(dev)
    else:
        gt_b = gt_audio[sl].to(dev)
    t0 = time.perf_counter()
    eig0 = model.eigen_decomposition()
    cold_s = time.perf_counter() - t0
    nl = sl.stop - sl.start
    eigval_b = eig0.eigenvalues.to(dev)[None].expand(nl, -1).clone()
    eigvec_b = eig0.eigenvectors.to(dev)[None].expand(nl, -1, -1).clone()
    if init_logits is None:
        params_b, opt_b = trainer.init(B)
    else:
        params_b = {k: v[sl].clone().requires_grad_(True)
                    for k, v in params_from_jax(init_logits, dev).items()}
        opt_b = torch.optim.Adam(list(params_b.values()), lr=trainer.lr)

    losses, refresh_s, refresh_iters = [], [], []
    step_s = 0.0
    _sync(dev)
    t_start = t0 = time.perf_counter()
    for epoch in range(flags.max_epoch):
        refresh = epoch % EIGEN_DECOMPOSE_CYCLE == 0 and epoch > 0
        if refresh:
            _sync(dev)
            step_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            eigval_b, eigvec_b, its = trainer.refresh(params_b, eigvec_b)
            _sync(dev)
            refresh_s.append(time.perf_counter() - t0)
            refresh_iters.append(dmesh.gather_pairs(torch.as_tensor(its, device=dev)).tolist())
            t0 = time.perf_counter()
        params_b, opt_b, loss_b, eigval_b, eigvec_b = trainer.step(
            params_b, opt_b, eigval_b, eigvec_b, gt_b)
        losses.append(loss_b)
        if epoch % EIGEN_DECOMPOSE_CYCLE == 0:
            lh = loss_b.double().cpu().numpy()
            E_b = trainer.youngs_poisson(params_b)[0].cpu().numpy()  # every rank gathers
            if logger:
                logger.scalars({f"loss_pair{i}": float(x) for i, x in enumerate(lh)}, epoch)
            if dmesh.dp_rank == dmesh.ep_rank == 0:
                print(f"epoch {epoch}: losses {lh.round(3).tolist()[:4]}... "
                      f"E[:4] {E_b[:4].tolist()}")
    _sync(dev)
    step_s += time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    E_b, nu_b = trainer.youngs_poisson(params_b)
    return {
        "youngs": E_b.double().cpu().numpy(), "poisson": nu_b.double().cpu().numpy(),
        "pair_iters_per_sec": flags.max_epoch * B / wall,
        "losses": torch.stack(losses).double().cpu().numpy() if losses else np.zeros((0, B)),
        "params": {k: v.detach() for k, v in params_b.items()},
        "eigval": eigval_b, "eigvec": eigvec_b, "gt": gt_b, "trainer": trainer,
        "cold_eig": eig0, "cold_s": cold_s, "refresh_s": refresh_s, "refresh_iters": refresh_iters,
        "step_s": step_s, "wall_s": wall,
    }


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags(
        "material_sync (diffsound-torch)", defaults={"parallel": False}, argv=argv
    )
    parallel = getattr(flags, "parallel", False)
    device = getattr(flags, "device", "cuda")
    rank = 0
    if parallel:
        from ..parallel.mesh import init_distributed

        rank, n = init_distributed(device)
        if n > 1 and torch.device(device).type == "cuda":
            device = f"cuda:{rank}"
    recipe = getattr(flags, "recipe", "newton")
    if recipe not in RECIPES:
        raise ValueError(f"recipe must be one of {RECIPES}, got {recipe!r}")
    os.makedirs(flags.out_dir, exist_ok=True)

    mesh_path = flags.mesh_dir
    if mesh_path.endswith(".obj"):
        mesh = TetMesh.from_triangle_mesh(mesh_path)
    else:
        mesh = TetMesh.from_file(mesh_path)

    task = MaterialSyncTask(
        mesh=mesh,
        mode_num=flags.mode_num,
        sample_rate=flags.sample_rate,
        frame_num=flags.frame_num,
        force_frame_num=flags.force_frame_num,
        exp_mode=flags.exp_mode,
        device=device,
    )

    pairs = flagship_material_pairs(getattr(flags, "num_material_pairs", 16))
    logger = MetricLogger(flags.out_dir) if rank == 0 else None
    results_path = os.path.join(flags.out_dir, "result.txt")

    if parallel:
        res = train_pairs_parallel(task, pairs, flags, logger)
        if rank == 0:
            with open(results_path, "a") as f:
                for i, (_, gt_mat) in enumerate(pairs):
                    f.write(
                        f"material:{i}\nyoungs:{res['youngs'][i]}\n"
                        f"poisson:{res['poisson'][i]}\n"
                        f"target youngs:{gt_mat[1]}\ntarget poisson:{gt_mat[2]}\n"
                    )
                f.write(f"pair_iters_per_sec:{res['pair_iters_per_sec']:.3f}\n")
            print(f"parallel run: {res['pair_iters_per_sec']:.2f} pair-iters/s")
        return

    # Resumability across pairs: completed pairs already sit in result.txt
    # (one "material:<i>" line each); skip them so a restarted run continues
    # where it left off, and checkpoint mid-pair progress.
    done_pairs = 0
    if os.path.exists(results_path):
        with open(results_path) as f:
            done_pairs = sum(1 for line in f if line.startswith("material:"))
        if done_pairs:
            print(f"result.txt already has {done_pairs} pairs; resuming after them")
    for i, (init_mat, gt_mat) in enumerate(pairs):
        if i < done_pairs:
            continue
        print(f"material pair {i}: target E={gt_mat[1]:.4g} nu={gt_mat[2]:.4f} "
              f"init E={init_mat[1]:.4g} nu={init_mat[2]:.4f}")
        gt_audio, _ = task.make_gt(gt_mat)
        if recipe == "newton":
            res = task.train_newton(
                init_mat, gt_audio,
                rounds=getattr(flags, "newton_rounds", 20),
                polish_epochs=getattr(flags, "polish_epochs", 300),
                logger=logger, seed=i,
                media_dir=os.path.join(flags.out_dir, f"media_pair{i}"),
            )
        else:
            res = task.train(
                init_mat, gt_audio,
                max_epoch=flags.max_epoch,
                early_loss_epoch=flags.early_loss_epoch,
                logger=logger,
                seed=i,
                checkpoint_dir=os.path.join(flags.out_dir, f"ckpt_pair{i}"),
                checkpoint_every=300,
                media_dir=os.path.join(flags.out_dir, f"media_pair{i}"),
                early_loss_type=getattr(
                    flags, "early_loss_type",
                    "geomloss" if recipe == "reference" else "freq_chamfer",
                ),
                late_freq_weight=getattr(
                    flags, "late_freq_weight",
                    0.0 if recipe == "reference" else 300.0,
                ),
            )
        with open(results_path, "a") as f:
            f.write(
                f"material:{i}\nyoungs:{res['youngs']}\npoisson:{res['poisson']}\n"
                f"target youngs:{gt_mat[1]}\ntarget poisson:{gt_mat[2]}\n"
                f"RMSE:{res['rmse']}\niters_per_sec:{res['iters_per_sec']:.3f}\n"
                f"wall_s:{res.get('wall_s', float('nan')):.1f}\n"
            )
        print(f"  -> recovered E={res['youngs']:.4g} nu={res['poisson']:.4f} "
              f"({res['iters_per_sec']:.2f} it/s, {res.get('wall_s', 0):.0f}s)")


if __name__ == "__main__":
    main()
