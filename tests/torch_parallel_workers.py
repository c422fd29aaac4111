"""The port's side of the multi-pair tests: the trainer at
tests/test_multipair.py's sizes (cube_tet_mesh(2, 0.5) at order 1, 4 modes,
T = 1000, two targets, float64), and the ranks of the gloo runs.  It
imports no JAX, so the spawned ranks start quickly."""

import os

import numpy as np
import torch

from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
from diffsound_torch.experiments.material_sync import impulse_forces
from diffsound_torch.fem import assembly
from diffsound_torch.fem.material import Material, lame_params
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.models.sound_obj import build_model
from diffsound_torch.parallel.mesh import make_device_mesh
from diffsound_torch.parallel.ops import ShardedFEM
from diffsound_torch.parallel.train import MultipairTrainer

BASE = (2700, 7.2e10, 0.19, 6, 1e-7)
TARGETS = [(2700, 6.8e10, 0.19, 6, 1e-7), (2700, 7.7e10, 0.19, 6, 1e-7)]
MODES, SR, T, NF = 4, 32000.0, 1000, 20
F64 = torch.float64


def fem_problem():
    """tests/test_parallel.py's problem: cube_tet_mesh(3) at order 1, f64;
    x (4, 3V, 2) four pairs' blocks."""
    mesh = cube_tet_mesh(3)
    ops = assembly.build_element_ops(torch.as_tensor(mesh.vertices), mesh.tets, 1)
    mu, lam = lame_params(2.1e7, 0.3)
    x = np.random.default_rng(0).standard_normal((4, 3 * mesh.num_vertices, 2))
    return mesh, ops, mu, lam, x


def pair_materials(mu, lam):
    """Each of fem_problem's four pairs' Lame values, (4,) each."""
    return (torch.tensor([mu, 0.5 * mu, 2 * mu, mu], dtype=F64),
            torch.tensor([lam, 2 * lam, 0.0, 3 * lam], dtype=F64))


def fem_results(dmesh):
    """Through ShardedFEM on dmesh: K and M (unit density) of every pair's
    block at its own material, bare and between the solve's Jacobi
    scalings; diag(K) at one material and at each pair's; the quadratic
    forms of the blocks."""
    _, ops, mu, lam, x = fem_problem()
    fem = ShardedFEM(ops, dmesh)
    X = torch.as_tensor(x)
    mus, lams = pair_materials(mu, lam)
    with torch.no_grad():
        d_cols = fem.k_diag(mus, lams)
        s = torch.rsqrt(d_cols).T.contiguous()
        return {"k": fem.k_pairs(X, mus, lams).numpy(),
                "k_scaled": fem.k_pairs(X, mus, lams, s).numpy(),
                "m": fem.m_pairs(X).numpy(), "m_scaled": fem.m_pairs(X, s).numpy(),
                "d": fem.k_diag(mu, lam).numpy(), "d_cols": d_cols.numpy(),
                "q": fem.quadratic_forms(X).numpy()}


def port_setup(dmesh, refresh_iters=2, refresh_tol=1e-3):
    """The port's trainer, this rank's eigval_b, eigvec_b (the cold basis
    broadcast) and gt_b at tests/test_multipair.py's build_setup."""
    mesh = cube_tet_mesh(2, size=0.5)
    forces = impulse_forces(1, NF, F64)
    model = build_model(mesh=mesh, mode_num=MODES, order=1, mat=BASE, task="mat_baseline",
                        dtype=F64, device="cpu")
    gt = []
    for t in TARGETS:
        gm = build_model(mesh=mesh, mode_num=MODES, order=1, mat=t, task="gt", dtype=F64,
                         device="cpu")
        freqs = gm.get_undamped_freqs({}, gm.eigen_decomposition(sigma=1e5))
        gt.append(TraditionalOscillatorParams(1, MODES, T, SR, Material.of(t))(
            freqs, forces, dtype=F64)[0])
    osc = TraditionalOscillatorParams(1, MODES, T, SR, Material.of(BASE))
    trainer = MultipairTrainer(bins=model.bins, ops=model.ops, osc=osc, mesh=dmesh,
                               forces=forces, sample_rate=SR, lr=5e-3,
                               refresh_iters=refresh_iters, refresh_tol=refresh_tol)
    eig0 = model.eigen_decomposition(sigma=1e5)
    sl = dmesh.pair_slice(len(TARGETS))
    n = sl.stop - sl.start
    return (model, trainer, eig0.eigenvalues[None].expand(n, -1).clone(),
            eig0.eigenvectors[None].expand(n, -1, -1).clone(), torch.stack(gt)[sl])


REFRESH_AT = (False, True, False)


def port_steps(trainer, params_b, opt_b, eigval_b, eigvec_b, gt_b):
    """Three steps, the second with a warm refresh: losses (3, B) and all
    pairs' final logits."""
    losses = []
    for refresh in REFRESH_AT:
        params_b, opt_b, loss_b, eigval_b, eigvec_b = trainer.step(
            params_b, opt_b, eigval_b, eigvec_b, gt_b, refresh=refresh)
        losses.append(loss_b.numpy())
    return np.stack(losses), {k: trainer.mesh.gather_pairs(v.detach()).numpy()
                              for k, v in params_b.items()}


def distributed_rank(rank, out_dir):
    """One rank of the 4-process gloo run: ShardedFEM at ep = 4 and at
    ep = 2, then the (dp = 2, ep = 2) trainer's three steps from the
    pretrained start; rank 0 writes what it saw."""
    out = {}
    for dp, ep in ((1, 4), (2, 2)):
        res = fem_results(make_device_mesh(dp, ep, "cpu"))
        out.update({f"ep{ep}_{k}": v for k, v in res.items()})
    dmesh = make_device_mesh(2, 2, "cpu")
    _, trainer, eigval_b, eigvec_b, gt_b = port_setup(dmesh)
    params_b, opt_b = trainer.init(len(TARGETS))
    losses, params = port_steps(trainer, params_b, opt_b, eigval_b, eigvec_b, gt_b)
    out["losses"] = losses
    out.update({f"param_{k}": v for k, v in params.items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)
