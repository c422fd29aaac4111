"""The one-card forward step on the flagship model: material parameters
(`MaterialBins`) -> Rayleigh-corrected modal frequencies through the order-2
element operators -> damped-oscillator synthesis (the CUDA synthesis kernels
on the card, forward and, under backward(), backward) -> five-scale L1
spectral loss.

Counterpart of the JAX package's entry (`__graft_entry__.py`:
`_flagship_pieces` and `entry`).  The mesh is the bowl where
`data/mesh/bowl/bowl.obj_.msh` sits inside the checkout, else
`cube_tet_mesh(4, 0.5)` (2,187 DOF at order 2).  The JAX entry looks for the
bowl at an absolute path outside the repository; the bowl is not in the
repository, so the two entries run the same mesh only on the cube fallback.

    python -m diffsound_torch.entry [--device cpu]

prints the step's loss on the card, then runs
`parallel.dryrun.dryrun_multichip(1)`.
"""

from __future__ import annotations

import argparse
import os

import torch

from . import default_dtype, resolve_device
from .audio.mss_loss import MSSLoss
from .audio.oscillator import TraditionalOscillatorParams
from .fem.material import Material
from .fem.mesh import TetMesh, cube_tet_mesh
from .models.sound_obj import EigenState, build_model

BOWL_MESH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data", "mesh", "bowl", "bowl.obj_.msh")
MAT = (2700, 7.2e10, 0.19, 6, 1e-7)
N_FFTS = (1024, 512, 256, 128, 64)
SAMPLE_RATE = 32000.0


def flagship_pieces(dtype=None, device="cuda", mesh_path: str = BOWL_MESH):
    """(model, osc, loss, forces): the order-2 material model with 16 modes,
    the fixed-table oscillator (1 row, 8000 samples at 32 kHz), the
    five-scale L1 loss and a unit impulse (1, 150).  dtype defaults to the
    device's (float32 on CUDA, float64 on the CPU)."""
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    mesh = TetMesh.from_file(mesh_path) if os.path.exists(mesh_path) else cube_tet_mesh(4, 0.5)
    model = build_model(mesh=mesh, mode_num=16, order=2, mat=MAT, task="material",
                        dtype=dtype, device=dev)
    osc = TraditionalOscillatorParams(1, 16, 8000, SAMPLE_RATE, Material.of(MAT))
    loss = MSSLoss(list(N_FFTS), SAMPLE_RATE, loss_type="l1_loss")
    forces = torch.zeros((1, 150), dtype=dtype, device=dev)
    forces[0, 0] = 1.0
    return model, osc, loss, forces


def entry(device="cuda", seed: int = 0, dtype=None):
    """(fn, args): fn(params, eigenvalues, eigenvectors, gt_audio, forces)
    is the step's loss, differentiable in params; args are drawn as the JAX
    entry draws them (its bins' logits, linspace(1e5, 5e9, 22) eigenvalues,
    normal x 1e-2 eigenvectors (num_dof, 22), a normal x 0.1 target (1,
    8000)), in float32 from a CPU torch.Generator seeded `seed`, so every
    device gets the same numbers; all but the params in the pieces' dtype."""
    model, osc, loss, forces = flagship_pieces(dtype, device)
    dev, dtype = model.device, model.dtype
    k = model.mode_num + model.extra_modes

    def fn(params, eigenvalues, eigenvectors, gt_audio, forces):
        eig = EigenState(eigenvalues, eigenvectors, 0, torch.zeros_like(eigenvalues))
        freqs = model.get_undamped_freqs(params, eig)
        sig, damped = osc(freqs, forces, dtype=dtype)
        return loss(sig, gt_audio, damped, 1.0)

    gen = torch.Generator().manual_seed(seed)
    params = {name: v.to(dev) for name, v in model.bins.init_params(gen).items()}
    eigenvalues = torch.linspace(1e5, 5e9, k, dtype=torch.float64).float()
    eigenvectors = torch.randn((model.num_dof, k), generator=gen) * 1e-2
    gt_audio = torch.randn((1, osc.sample_num), generator=gen) * 0.1
    as_dev = lambda x: x.to(device=dev, dtype=dtype)
    return fn, (params, as_dev(eigenvalues), as_dev(eigenvectors), as_dev(gt_audio), forces)


def main(argv=None):
    from .parallel.dryrun import dryrun_multichip

    parser = argparse.ArgumentParser(description="the flagship forward step (diffsound-torch)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry loss:", float(fn(*fargs)))
    dryrun_multichip(1, args.device)


if __name__ == "__main__":
    main()
