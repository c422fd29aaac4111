"""The benchmark's inputs, made from the configuration, the traffic and the
seed, and handed alike to the program and to the plain reference.

Seed-independent parts (the mesh's cold eigenbasis at the init material,
the modal table of every target Poisson ratio, the pretrained bin logits)
come from host solves of the reference's own assembled K and M and are
kept in a fixed cache directory inside the checkout, so only a cell's
first run in a checkout pays for them.  The seed draws each pair's
target E inside its own stratum of the traffic's range and deals the
targets to the pairs (`draw_targets`).  The target recordings are
synthesized by the reference from the 16 modes of that (E, nu): E scales
every eigenvalue, so one solve per nu serves every E.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from reference import fem, model
from reference.mesh import make_mesh

CACHE_VERSION = 1
PRETRAIN_STEPS, PRETRAIN_LR = 5000, 5e-3
TRAFFIC_KEYS = {"pairs", "target_E", "E_jitter", "target_nu", "note"}


def cache_dir() -> str:
    """`.portbench_cache/` at the root of the checkout (the command runs
    from there)."""
    return os.path.join(os.getcwd(), ".portbench_cache")


def _cache_key(cfg: dict, traffic: dict) -> str:
    keys = {k: cfg[k] for k in ("mesh", "order", "init_material", "mode_num", "extra_modes")}
    keys["nu_set"] = traffic["target_nu"]
    keys["version"] = CACHE_VERSION
    return hashlib.sha256(json.dumps(keys, sort_keys=True).encode()).hexdigest()[:16]


def pretrained_logits(mat) -> dict:
    """Bin logits uniform in [-1, 1) (generator seed 0, as the recipe draws
    every pair's), fitted by 5000 Adam steps (lr 5e-3) to the init
    material's (E, nu), in float64."""
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.rand(16, generator=gen, dtype=torch.float64) * 2.0 - 1.0
         for k in ("youngs_logits", "poisson_logits")}
    yv, pv = (torch.as_tensor(v) for v in model.bin_values(mat))
    E0, nu0 = float(mat[1]), float(mat[2])
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    opt = torch.optim.Adam(list(p.values()), lr=PRETRAIN_LR)
    for _ in range(PRETRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        E = model.weighted(p["youngs_logits"], yv)
        nu = model.weighted(p["poisson_logits"], pv)
        ((E - E0) ** 2 / E0 ** 2 + (nu - nu0) ** 2 / nu0 ** 2).backward()
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}


def seed_free(cfg: dict, traffic: dict, mesh) -> dict:
    """The cached seed-independent inputs (computed on a miss)."""
    path = os.path.join(cache_dir(), f"inputs_{_cache_key(cfg, traffic)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    verts, tets = mesh
    el = fem.elements(verts, tets, cfg["order"])
    mat = cfg["init_material"]
    k = cfg["mode_num"] + cfg["extra_modes"]
    E0, rho = float(mat[1]), float(mat[0])
    solves = [(E0, float(mat[2]))] + [(E0, float(nu)) for nu in traffic["target_nu"]]
    with ThreadPoolExecutor(len(solves)) as ex:
        sols = list(ex.map(lambda s: fem.lowest_modes(el, *model.lame(s[0] / rho, s[1]), k), solves))
    lg = pretrained_logits(mat)
    out = {"theta": sols[0][0], "basis": sols[0][1],
           "nu_theta": np.stack([s[0] for s in sols[1:]]),
           "youngs_logits": lg["youngs_logits"], "poisson_logits": lg["poisson_logits"]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def draw_targets(traffic: dict, seed: int):
    """(E (B,), index into the nu set (B,)) of every pair: E drawn from the
    seed, uniform in the log over the middle E_jitter share of the i-th of
    B equal log strata of the traffic's range, nu cycling through its set,
    the B targets dealt to the pairs in an order drawn from the seed.
    Every seed gives the same set of nu and one E in each stratum; where in
    its stratum each E falls moves how many LOBPCG sweeps a refresh takes,
    and E_jitter bounds that."""
    B = int(traffic["pairs"])
    nus = traffic["target_nu"]
    lo, hi = (float(x) for x in traffic["target_E"])
    jit = float(traffic["E_jitter"])
    rng = np.random.default_rng(int(seed))
    E = lo * (hi / lo) ** ((np.arange(B) + (1.0 - jit) / 2 + jit * rng.random(B)) / B)
    nu_idx = np.arange(B) % len(nus)
    order = rng.permutation(B)
    return E[order], nu_idx[order]


def make(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Every input of a run: the mesh, the cold basis (float32-rounded, as
    both sides receive it), the targets (B, T) float32, the init logits
    (B, 16) float32 per leaf, the force."""
    mesh = make_mesh(cfg["mesh"], cfg["order"])
    free = seed_free(cfg, traffic, mesh)
    mat = cfg["init_material"]
    E, nu_idx = draw_targets(traffic, seed)
    scale = E / float(mat[1])
    theta_t = free["nu_theta"][nu_idx] * scale[:, None]  # eigenvalues scale with E
    extra = cfg["extra_modes"]
    f_t = np.sqrt(np.maximum(theta_t[:, extra:], 1e-3)) / (2.0 * np.pi)
    force = np.zeros(int(cfg["force_frame_num"]))
    force[0] = 1.0
    with torch.no_grad():
        sig = model.signals(torch.as_tensor(f_t, device=device), mat, cfg,
                            torch.as_tensor(force, device=device))
    B = int(traffic["pairs"])
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "verts": mesh[0], "tets": mesh[1],
        "theta": f32(free["theta"]), "basis": f32(free["basis"]),
        "targets": f32(sig.cpu().numpy()),
        "logits": {k: np.repeat(f32(free[k])[None], B, axis=0)
                   for k in ("youngs_logits", "poisson_logits")},
        "force": force,
    }
