"""Whether what the timed path produced is correct: the plain reference
(`reference/`, float64) judges each stage of the first steps and of the
first refresh, and each number below is held to its limit.

  freq           the first step's frequencies (forms of the cold basis,
                 Rayleigh correction at the init logits) against the
                 reference's from the same inputs, worst relative gap
  loss           the first three steps' per-pair losses against the
                 reference's losses of the same frequencies, worst
                 relative gap
  grad           the first gradient as Adam holds it, by the median leaf:
                 for each leaf (one pair's youngs or poisson logits) the
                 gap between the norms of the program's and the reference's
                 gradient, over the larger of that leaf's and the median
                 leaf's reference norm; the median of these gaps
  grad_worst     the same gaps of the first gradient, the worst leaf: a
                 pair whose backward goes wrong alone moves it and not the
                 median
  change         the logits' change over the three steps, the same way;
                 leaves whose reference gradient is under a thousandth of
                 the median leaf's are left out (they move by round-off)
  refresh_resid  the first refresh's eigenpairs: max over pairs and columns
                 of |K u - theta M u| / (theta_max |M u|) in float64, with
                 K at the material of the logits the refresh ran at
  refresh_lowest whether those are the lowest k: the float64 Ritz values
                 of K and M at that material over the span of the cold
                 basis (the refresh's start) and the refreshed columns are
                 upper bounds of the k lowest eigenvalues, so a refresh
                 that skipped a mode reads theta_j above the j-th of them;
                 max over pairs and j of (theta_j - ritz_j) / theta_max
  refresh_freq   the frequencies of the step after that refresh against
                 the reference's Rayleigh correction of the refreshed pairs
                 at that material, worst relative gap

For loss, grad and change the reference follows the three steps from the
inputs with its frequencies' values pinned to the program's of the same
step (their derivative in the logits stays the reference's own): float32
forms leave the frequencies ~1e-5 off, which turns the phase of an 8000-
sample signal by ~0.1 rad at its end, and the L1 of log spectra and its
gradient then read that turn, not the stages after it.  The refresh comes
after 15 Adam steps, over which float32 and float64 trajectories part, so
the reference takes the logits at the refresh from the program's state and
works the material out again.  grad and change are taken at the median
leaf: a pair whose prediction sits near its target in E has an E-gradient
that nearly cancels, a sum of the L1's signs over bins where prediction
and target meet, and float32 flips some of those signs, so the worst
leaf's gap is larger than the median's; with the frequencies pinned it
is steady from seed to seed, and `grad_worst` holds it (`change_worst` is
not compared).  It reads the program's outputs only to
judge them or to follow from them.  It runs on the card, in float64,
after the window has closed and the program's state is freed, one pair's
columns at a time where it applies K and M.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import fem, model

NAMES = ("freq", "loss", "grad", "grad_worst", "change", "refresh_resid", "refresh_lowest",
         "refresh_freq")


def _leaf_norms(tree: dict):
    """{name: (B,) norms of each pair's row}, flattened to one array."""
    return np.concatenate([np.linalg.norm(np.asarray(v, np.float64), axis=1)
                           for _, v in sorted(tree.items())])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> np.ndarray:
    """Per leaf |norm(prog) - norm(ref)| / max(norm(ref), median)."""
    p, r = _leaf_norms(prog), _leaf_norms(ref)
    if keep is not None:
        p, r = p[keep], r[keep]
    floor = max(float(np.median(r)), np.finfo(np.float64).tiny)
    return np.abs(p - r) / np.maximum(r, floor)


def _steps(rec: dict, ref: dict) -> dict:
    """loss, grad and change of the program's record against a reference
    run of three steps."""
    host = lambda t: t.detach().cpu().numpy()
    lp = np.stack(rec["losses"])
    lr = np.stack([host(x) for x in ref["losses"][:3]])
    g_ref = {k: host(v) for k, v in ref["grad"].items()}
    gn = _leaf_norms(g_ref)
    keep = gn >= 1e-3 * np.median(gn)
    d_prog = {k: rec["p3"][k] - rec["p0"][k] for k in rec["p0"]}
    d_ref = {k: host(ref["params"][3][k] - ref["params"][0][k]) for k in rec["p0"]}
    g, d = leaf_gaps(rec["grad"], g_ref), leaf_gaps(d_prog, d_ref, keep)
    return {"loss": float(np.max(np.abs(lp - lr) / np.abs(lr))),
            "grad": float(np.median(g)), "change": float(np.median(d)),
            "grad_worst": float(g.max()), "change_worst": float(d.max())}


def numbers(rec: dict, inputs: dict, cfg: dict, device, unpinned: bool = False) -> dict:
    """Every number of a run's record `rec` (host arrays): those of NAMES
    are compared; with unpinned, also loss, grad and change against the
    reference's own frequencies (`*_unpinned`, not compared)."""
    el = fem.elements(inputs["verts"], inputs["tets"], cfg["order"], device=device)
    ref = model.follow(el, inputs, cfg, steps=3, pinned=rec["freqs"])
    f_ref = ref["free_freqs"][0].cpu().numpy()
    out = {"freq": float((np.abs(rec["freqs"][0] - f_ref) / f_ref).max())}
    out.update(_steps(rec, ref))
    if unpinned:
        free = _steps(rec, model.follow(el, inputs, cfg, steps=3))
        out.update({f"{k}_unpinned": v for k, v in free.items()})

    # the first refresh, at the material of the logits it ran at
    p = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
         for k, v in rec["p_refresh"].items()}
    mu, lam = model.material_lame(p, cfg["init_material"])
    U0 = torch.as_tensor(inputs["basis"], dtype=torch.float64, device=device)
    kmu0, klam0 = fem.apply_k_parts(el, U0)
    MU0 = fem.apply_m(el, U0)
    resid, lowest, fgap = [], [], []
    extra = int(cfg["extra_modes"])
    for b in range(rec["eigvec"].shape[0]):
        U = torch.as_tensor(rec["eigvec"][b], dtype=torch.float64, device=device)
        th = torch.as_tensor(rec["eigval"][b], dtype=torch.float64, device=device)
        kmu, klam = fem.apply_k_parts(el, U)
        MU = fem.apply_m(el, U)
        KU = mu[b] * kmu + lam[b] * klam
        scale = th.abs().max()
        r = torch.linalg.vector_norm(KU - MU * th, dim=0)
        resid.append(float((r / (scale * torch.linalg.vector_norm(MU, dim=0))).max()))
        ritz = ritz_values(torch.cat([U0, U], 1), torch.cat([mu[b] * kmu0 + lam[b] * klam0, KU], 1),
                           torch.cat([MU0, MU], 1))[:th.shape[0]]
        lowest.append(float(((torch.sort(th).values - ritz) / scale).max()))
        lt = th + (U * KU).sum(0) - th * (U * MU).sum(0)
        f_ref = torch.sqrt(torch.clamp(lt[extra:], min=1e-3)) / (2.0 * math.pi)
        f_prog = torch.as_tensor(rec["freqs_after"][b], dtype=torch.float64, device=device)
        fgap.append(float(((f_prog - f_ref).abs() / f_ref).max()))
    out["refresh_resid"] = max(resid)
    out["refresh_lowest"] = max(lowest)
    out["refresh_freq"] = max(fgap)
    return out


def ritz_values(S: torch.Tensor, KS: torch.Tensor, MS: torch.Tensor) -> torch.Tensor:
    """Ascending Ritz values of the pencil (K, M) over the span of the
    columns of S, given K S and M S; directions that M sees as dependent
    (relative Gram eigenvalue under 1e-12) are dropped."""
    A, B = S.T @ KS, S.T @ MS
    A, B = (A + A.T) / 2, (B + B.T) / 2
    d = torch.rsqrt(torch.diagonal(B))
    w, V = torch.linalg.eigh(B * d[:, None] * d[None, :])
    keep = w > 1e-12 * w.max()
    T = d[:, None] * V[:, keep] / torch.sqrt(w[keep])
    return torch.linalg.eigvalsh(T.T @ A @ T)


def judge(values: dict, limits: dict, names) -> tuple:
    """(correct, [(name, value, limit)]) over every number of `names` (the
    driver's NAMES); a number that is not finite fails, and a cell whose
    limits leave one out is refused."""
    missing = [k for k in names if k not in limits]
    if missing:
        raise KeyError(f"the cell's limits leave out {missing}")
    rows = [(k, float(values[k]), float(limits[k])) for k in names]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
