"""Synthetic-material inference: recover (E, nu) from modal audio.

Counterpart of `diffsound_tpu/experiments/material_sync.py` for the
multi-scale-L1 recipe: ground-truth audio from an order-2 fixed-material
model and a fixed-table oscillator; the trainable model optimizes its
material bins so its synthesized audio matches, with Adam and a step-decayed
learning rate, and a warm LOBPCG eigensolve refresh every 15 epochs.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md item):
the `newton` recipe (models/modal_fit.py + audio/freq_loss.py), the
`freq_chamfer` early phase and late auxiliary (audio/freq_loss.py), the
`geomloss` Sinkhorn early phase (audio/sinkhorn.py), and the parallel
multi-pair trainer (parallel/).

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
from ..audio.mss_loss import MSSLoss
from ..audio.oscillator import TraditionalOscillatorParams
from ..convert import params_from_jax
from ..fem.material import Material
from ..fem.mesh import TetMesh
from ..models.sound_obj import build_model
from ..utils.logging import MetricLogger

EIGEN_DECOMPOSE_CYCLE = 15

_FREQ_LOSS_TODO = (
    "needs audio/freq_loss.py, not ported yet: ROADMAP.md Queue 1, "
    "'freq_loss + modal_fit'"
)
_SINKHORN_TODO = (
    "needs audio/sinkhorn.py, not ported yet: ROADMAP.md Queue 1, 'sinkhorn'"
)

# The 16 flagship (init, target) material pairs: the JAX package's
# random_material_pairs(jax.random.PRNGKey(0), 16), generated once and kept
# as data (its draws are prefix-stable, so the first n equal a draw of n).
FLAGSHIP_PAIRS = (
    ((2700, 97295319819.09, 0.29557667667446863, 6, 1e-07), (2700, 17256192999.788445, 0.3251706648746635, 6, 1e-07)),
    ((2700, 38366367389.5272, 0.36386355753292665, 6, 1e-07), (2700, 93155395200.52727, 0.24389401898402316, 6, 1e-07)),
    ((2700, 69498675142.34724, 0.1639605429290496, 6, 1e-07), (2700, 76055711062.30048, 0.3933749513507332, 6, 1e-07)),
    ((2700, 99224813051.95615, 0.24397212836844578, 6, 1e-07), (2700, 62150521984.010155, 0.15808051405588308, 6, 1e-07)),
    ((2700, 35426938762.57178, 0.2509717121588867, 6, 1e-07), (2700, 63784270537.29928, 0.1410656978001336, 6, 1e-07)),
    ((2700, 41993989564.96659, 0.1836864013533659, 6, 1e-07), (2700, 73002396584.73997, 0.18694280487979964, 6, 1e-07)),
    ((2700, 57273140420.307945, 0.20181802875926363, 6, 1e-07), (2700, 82505808757.55249, 0.15405970642555145, 6, 1e-07)),
    ((2700, 39034751474.70484, 0.36716872934618205, 6, 1e-07), (2700, 90052303158.31125, 0.359995708237865, 6, 1e-07)),
    ((2700, 15280996698.146313, 0.29531188822781707, 6, 1e-07), (2700, 16865099327.210386, 0.25268569416676856, 6, 1e-07)),
    ((2700, 65359998469.818344, 0.12739626281129443, 6, 1e-07), (2700, 88557225177.73997, 0.2111466578923133, 6, 1e-07)),
    ((2700, 95925311360.8303, 0.1570314881475178, 6, 1e-07), (2700, 30397544226.260788, 0.12519907661186502, 6, 1e-07)),
    ((2700, 85488981225.5374, 0.27188558981707633, 6, 1e-07), (2700, 69078088904.25967, 0.23182274998156535, 6, 1e-07)),
    ((2700, 81355395185.5153, 0.21574188477514236, 6, 1e-07), (2700, 36302083295.06569, 0.16047461792217832, 6, 1e-07)),
    ((2700, 26031542048.759346, 0.1652058054031535, 6, 1e-07), (2700, 69366079825.3482, 0.12173036156844547, 6, 1e-07)),
    ((2700, 43578251674.728195, 0.13617554857598624, 6, 1e-07), (2700, 66642861792.01294, 0.39671327807181467, 6, 1e-07)),
    ((2700, 79228443263.87845, 0.3819647183225525, 6, 1e-07), (2700, 51578376155.320816, 0.31130971106284794, 6, 1e-07)),
)


def flagship_material_pairs(n: int = 16):
    """The first n flagship (init, target) pairs."""
    if not 0 <= n <= len(FLAGSHIP_PAIRS):
        raise ValueError(f"the flagship table holds {len(FLAGSHIP_PAIRS)} pairs, asked for {n}")
    return list(FLAGSHIP_PAIRS[:n])


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
        init_logits: Optional[dict] = None,
    ) -> dict:
        """Train the material bins against `gt_audio` (A, T).

        The port runs the late multi-scale-L1 phase: early_loss_epoch must
        be 0, and with early_loss_type 'freq_chamfer' late_freq_weight must
        be 0 (both need modules not ported yet).  init_logits: optional dict
        of numpy logits used instead of the seeded random draw (to start from
        exactly the JAX package's draw).

        Returns recovered E/nu, the loss per epoch, the log history, and the
        timing: wall seconds of each cold solve (host ARPACK plus the modal
        cache), of each warm refresh with its LOBPCG iterations and Lame
        values, and of all steps, with a device sync at each solve and at
        the end of each chunk of steps."""
        if early_loss_epoch > 0:
            todo = _SINKHORN_TODO if early_loss_type == "geomloss" else _FREQ_LOSS_TODO
            raise NotImplementedError(f"early loss phase '{early_loss_type}' {todo}")
        if early_loss_type == "freq_chamfer" and late_freq_weight > 0:
            raise NotImplementedError(f"late_freq_weight > 0 {_FREQ_LOSS_TODO}")
        dev = self.device
        model = self._build(init_mat, self.mesh_order, self.task)
        gt_audio = gt_audio.to(device=dev, dtype=self.dtype)
        osc = TraditionalOscillatorParams(
            gt_audio.shape[0], self.mode_num, self.frame_num, self.sample_rate,
            Material.of(init_mat),
        )
        forces = impulse_forces(gt_audio.shape[0], self.force_frame_num, self.dtype, dev)
        late_loss = MSSLoss([1024, 512, 256, 128, 64], self.sample_rate, loss_type="l1_loss")
        rmse_loss = MSSLoss([1024, 512, 256, 128, 64], self.sample_rate, loss_type="rmse_loss")

        if init_logits is None:
            params = model.init_params(seed, pretrain=False)
        else:
            params = params_from_jax(init_logits, dev)
        if pretrain:
            params = model.bins.pretrain(params)
        for v in params.values():
            v.requires_grad_(True)

        def make_opt(lr, gamma):
            return adam_step_decay(list(params.values()), lr, gamma)

        def phase_opt(epoch):
            return make_opt(lr_early, 0.9) if epoch < early_loss_epoch else make_opt(lr_late, 0.95)

        with torch.no_grad():
            tc_late = late_loss.target_cache(gt_audio)
            tc_rmse = rmse_loss.target_cache(gt_audio)

        def loss_with(loss_fn, cache, tc):
            freqs = model.get_undamped_freqs_cached(params, cache)
            sig, damped = osc(freqs, forces, dtype=self.dtype)
            return loss_fn(sig, None, damped, 1.0, target_cache=tc)

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
        cold_s, refresh_s, refresh_iters, refresh_lame = [], [], [], []
        step_s = 0.0
        t_start = time.perf_counter()

        def next_boundary(e):
            """First epoch > e where host work is due (refresh / logging /
            checkpoint / end)."""
            cands = [max_epoch]
            for period in (EIGEN_DECOMPOSE_CYCLE, log_every):
                cands.append((e // period + 1) * period)
            if ckpt is not None:
                cands.append((e // checkpoint_every + 1) * checkpoint_every)
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
            if epoch == early_loss_epoch:
                opt, sched = make_opt(lr_late, 0.95)
            log_this = epoch % log_every == 0
            log_epoch = epoch
            n = next_boundary(epoch) - epoch
            t0 = time.perf_counter()
            chunk = []
            for _ in range(n):
                opt.zero_grad(set_to_none=True)
                loss = loss_with(late_loss, cache, tc_late)
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
            "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
            "wall_s": wall,
            "iters_per_sec": n_steps / wall,
            "eig": eig,
            "cold_s": cold_s,
            "refresh_s": refresh_s,
            "refresh_iters": refresh_iters,
            "refresh_lame": refresh_lame,
            "step_s": step_s,
        }

    def train_newton(self, *args, **kwargs):
        """Modal-Newton material fit: not ported yet."""
        raise NotImplementedError(f"the newton recipe {_FREQ_LOSS_TODO}")


def main(argv=None):
    from ..config import parse_flags

    flags = parse_flags(
        "material_sync (diffsound-torch)", defaults={"parallel": False}, argv=argv
    )
    if getattr(flags, "parallel", False):
        raise NotImplementedError(
            "parallel multi-pair training needs parallel/, not ported yet: "
            "ROADMAP.md Queue 1, 'parallel'"
        )
    recipe = getattr(flags, "recipe", "newton")
    if recipe == "newton":
        raise NotImplementedError(f"recipe 'newton' {_FREQ_LOSS_TODO}")
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
        device=getattr(flags, "device", "cuda"),
    )

    pairs = flagship_material_pairs(getattr(flags, "num_material_pairs", 16))
    logger = MetricLogger(flags.out_dir)
    results_path = os.path.join(flags.out_dir, "result.txt")

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
