"""A short multi-pair training run over an n-rank mesh, with convergence
and cross-rank gates: the counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`.

Setup as there: `cube_tet_mesh(2, 0.5)` at order 1, 4 modes, T = 512 at
32 kHz, one pair per dp rank with a distinct target E (5.4e10 .. 8.6e10),
60 steps (the first 30 on the early-phase geomloss, then L1) and a warm
refresh every 15.  Gates: distinct first-step losses across pairs, each E
closing more than 10% of its own gap from the 7.2e10 start, the recovered
E ordered like the targets, and the late loss falling.  With n > 1 in a
process of its own it spawns the n ranks (gloo on the CPU, NCCL on CUDA),
the counterpart of the JAX package's emulated CPU mesh.

    python -c "from diffsound_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..audio.oscillator import TraditionalOscillatorParams
from ..fem.material import Material
from ..fem.mesh import cube_tet_mesh
from ..models.sound_obj import build_model
from .mesh import make_device_mesh, spawn, world
from .train import MultipairTrainer

BASE = (2700, 7.2e10, 0.19, 6, 1e-7)


def _rank(rank, n_devices, device):
    dryrun_multichip(n_devices, device)


def dryrun_multichip(n_devices: int = 1, device="cuda", timeout: float = 600.0):
    """Run the dryrun on an n_devices mesh (ep = 2 from 4 ranks on, as in
    the JAX package); returns its summary (None where it spawned the
    ranks).  Raises when a gate fails."""
    resolve_device(device)
    _, n = world()
    if n_devices > 1 and n == 1:
        spawn(_rank, n_devices, (n_devices, str(device)), device=device, timeout=timeout)
        return None
    if n != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of {n}")
    ep = 2 if n_devices >= 4 else 1
    dp = n_devices // ep
    dmesh = make_device_mesh(dp, ep, device)
    dev = dmesh.device
    dtype = default_dtype(dev)

    mesh = cube_tet_mesh(2, size=0.5)
    mode_num, sr, T = 4, 32000.0, 512
    model = build_model(mesh=mesh, mode_num=mode_num, order=1, mat=BASE, task="material",
                        dtype=dtype, device=dev)
    osc = TraditionalOscillatorParams(1, mode_num, T, sr, Material.of(BASE))
    forces = torch.zeros((1, 20), dtype=dtype, device=dev)
    forces[0, 0] = 1.0
    trainer = MultipairTrainer(
        bins=model.bins, ops=model.ops, osc=osc, mesh=dmesh, forces=forces,
        n_ffts=(256, 128), sample_rate=sr, lr=5e-3, refresh_iters=2,
    )

    B = dp  # one material pair per dp rank
    sl = dmesh.pair_slice(B)
    eig0 = model.eigen_decomposition(sigma=1e5)
    n_local = sl.stop - sl.start
    eigval_b = eig0.eigenvalues[None].expand(n_local, -1).clone()
    eigvec_b = eig0.eigenvectors[None].expand(n_local, -1, -1).clone()

    # real synthesized targets, a distinct E per dp rank: a mix-up of pair
    # data across ranks shows as equal losses or an E drifting the wrong way
    E_targets = np.linspace(5.4e10, 8.6e10, B)
    gt = []
    for E_t in E_targets[sl]:
        t_mat = (2700, float(E_t), 0.19, 6, 1e-7)
        gt_model = build_model(mesh=mesh, mode_num=mode_num, order=1, mat=t_mat, task="gt",
                               dtype=dtype, device=dev)
        gt_freqs = gt_model.get_undamped_freqs({}, gt_model.eigen_decomposition(sigma=1e5))
        gt_osc = TraditionalOscillatorParams(1, mode_num, T, sr, Material.of(t_mat))
        gt.append(gt_osc(gt_freqs, forces, dtype=dtype)[0])
    gt_b = torch.stack(gt)

    # bins pretrained to the base material's table value (random logits
    # start E about 2.5x high, which 60 steps cannot close)
    params_b, opt_b = trainer.init(B, pretrain=True)
    first_loss = None
    for step_i in range(60):
        params_b, opt_b, loss_b, eigval_b, eigvec_b = trainer.step(
            params_b, opt_b, eigval_b, eigvec_b, gt_b,
            refresh=(step_i % 15 == 0 and step_i > 0), early=step_i < 30,
        )
        if step_i == 0 and B > 1:
            l0 = loss_b.double().cpu().numpy()
            if np.unique(l0.round(6)).size < B:
                raise RuntimeError(f"per-rank losses not distinct: {l0}")
        if step_i == 30:  # the first late-phase (L1) loss
            first_loss = loss_b.double().cpu().numpy()
    loss_b = loss_b.double().cpu().numpy()
    if not np.all(np.isfinite(loss_b)):
        raise RuntimeError(f"non-finite losses from the multi-pair step: {loss_b}")
    E_b = trainer.youngs_poisson(params_b)[0].double().cpu().numpy()
    gap0 = np.abs(BASE[1] - E_targets)
    gaps = np.abs(E_b - E_targets)
    if not np.all(gaps < 0.9 * gap0 + 1e8):
        raise RuntimeError(f"training did not move E toward each pair's target: {E_b} "
                           f"(targets {E_targets.tolist()}, init {BASE[1]:.3g})")
    if B > 1 and not np.all(np.diff(E_b) > 0):
        raise RuntimeError(f"recovered E not ordered like the (increasing) targets: {E_b}")
    if loss_b.mean() >= first_loss.mean() or np.any(loss_b > 1.05 * first_loss):
        raise RuntimeError(f"late-phase loss did not decrease: {first_loss} -> {loss_b}")
    if dmesh.dp_rank == 0 and dmesh.ep_rank == 0:
        print(f"dryrun_multichip OK: mesh (dp={dp}, ep={ep}) on {dev}, losses "
              f"{loss_b.tolist()}, E {E_b.tolist()} -> targets {E_targets.tolist()}",
              flush=True)
    return {"dp": dp, "ep": ep, "losses": loss_b, "first_late_losses": first_loss, "E": E_b,
            "targets": E_targets}
