"""Debiased Sinkhorn divergence for spectrogram point clouds.

Counterpart of `diffsound_tpu/audio/sinkhorn.py`: log-domain symmetric
Sinkhorn with epsilon-scaling annealing, debiased

    S_eps(a, b) = OT_eps(a, b) - 1/2 OT_eps(a, a) - 1/2 OT_eps(b, b).

Batched over the leading axis (the JAX package vmaps it).  The annealing
runs as a Python loop of 32 steps plus a final pair of updates, and autograd
flows through every iteration: the potentials are not detached.  The cost
matrices are (n, m) per batch element, so autograd keeps about 200 of them
per divergence.
"""

from __future__ import annotations

import math

import torch

STEPS = 32


def _logsumexp(x, dim):
    """log sum exp over `dim`, as the JAX package computes it: the max is
    taken apart and detached, so the gradient is the softmax
    exp(x - max) / sum, whose differences x - max are exact in float32.
    torch.logsumexp's backward takes exp(x - result) instead, and at
    eps = blur^2 the float32 result (|C| / eps reaches 1e14) is off by up to
    half its ulp, about 4e6: every weight then rounds to 0 or overflows.

    The exp-sum accumulates in float64 and is cast back after the log
    (a no-op for a float64 input): summed in float32 over the 1025 points of an n_fft 2048 cloud,
    its rounding carried the divergence 4.0e-6 from float64, 20 times the
    JAX package's gap.  The gradient stays the softmax, in the input's
    dtype."""
    m = x.detach().amax(dim=dim, keepdim=True)
    e = (x - m).exp()
    lse = e.sum(dim=dim, dtype=torch.float64).log().to(x.dtype)
    return lse + m.squeeze(dim)


def _cost(x, y):
    """Halved squared euclidean cost C_ij = |x_i - y_j|^2 / 2 (geomloss p=2
    convention): x (B, n, d), y (B, m, d) -> (B, n, m)."""
    return 0.5 * ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(dim=-1)


def _sinkhorn_potentials(Cxy, Cyx, loga, logb, eps_schedule):
    """Symmetric log-domain Sinkhorn with annealed epsilon.  Cxy (B, n, m),
    Cyx (B, m, n), loga (n,), logb (m,), eps_schedule (B, steps).  Returns
    the final potentials (f (B, n) on x, g (B, m) on y)."""
    f = torch.zeros_like(Cxy[:, :, 0])
    g = torch.zeros_like(Cyx[:, :, 0])

    def f_update(g, eps):  # eps (B, 1, 1); softmin of C - g - eps logb
        return -eps[:, :, 0] * _logsumexp(
            (g[:, None, :] + eps * logb[None, None, :] - Cxy) / eps, dim=2)

    def g_update(f, eps):
        return -eps[:, :, 0] * _logsumexp(
            (f[:, None, :] + eps * loga[None, None, :] - Cyx) / eps, dim=2)

    for t in range(eps_schedule.shape[1]):
        eps = eps_schedule[:, t, None, None]
        ft, gt = f_update(g, eps), g_update(f, eps)
        # symmetric (averaged) update for stability
        f = 0.5 * (f + ft)
        g = 0.5 * (g + gt)
    # one final pair of full updates at the target epsilon
    eps = eps_schedule[:, -1, None, None]
    f = f_update(g, eps)
    g = g_update(f, eps)
    return f, g


def _eps_schedule(diameter2, blur, scaling, steps: int = STEPS):
    """Annealed epsilon ladder from the squared diameter (B,) down to
    blur^2, with a fixed number of steps: extra steps clamp at the target
    epsilon and are no-ops, so the ladder adapts to the data scale (a fixed
    guess explodes in f32 when spectrogram features span 1e5).
    Returns (B, steps)."""
    eps_end = float(blur) ** 2
    eps_start = torch.clamp(diameter2, min=eps_end)
    t = torch.arange(steps, dtype=diameter2.dtype, device=diameter2.device)
    return torch.clamp(eps_start[:, None] * (scaling**2) ** t[None, :], min=eps_end)


def _diameter2(x, y):
    """Squared-diameter upper bound of each joint cloud (sum of per-dim
    squared ranges), detached: x (B, n, d), y (B, m, d) -> (B,)."""
    x, y = x.detach(), y.detach()
    lo = torch.minimum(x.amin(dim=1), y.amin(dim=1))
    hi = torch.maximum(x.amax(dim=1), y.amax(dim=1))
    return ((hi - lo) ** 2).sum(dim=-1)


def sinkhorn_divergence(
    x: torch.Tensor,
    y: torch.Tensor,
    blur: float = 0.01,
    scaling: float = 0.5,
) -> torch.Tensor:
    """Debiased Sinkhorn divergence between uniform point clouds, batched:
    x (B, n, d), y (B, m, d) -> (B,).  The epsilon ladder adapts to each
    batch element's cloud diameter."""
    n, m = x.shape[1], y.shape[1]
    loga = torch.full((n,), -math.log(n), dtype=x.dtype, device=x.device)
    logb = torch.full((m,), -math.log(m), dtype=x.dtype, device=x.device)
    sched = _eps_schedule(_diameter2(x, y), blur, scaling)

    # The transposed costs are made contiguous so that both updates reduce
    # over a contiguous axis in one order: a self problem's cost is exactly
    # symmetric, so its f and g then stay bit for bit equal, as in the JAX
    # package.  Reduced over a strided transpose, g drifts an ulp of the
    # potentials from f at the large epsilons (4e-3 at |f| ~ 4e4 in
    # float32), and the averaged update never damps f - g.
    Cxy = _cost(x, y)
    f_ab, g_ab = _sinkhorn_potentials(Cxy, Cxy.transpose(1, 2).contiguous(), loga, logb, sched)
    Cxx = _cost(x, x)
    f_aa, _ = _sinkhorn_potentials(Cxx, Cxx.transpose(1, 2).contiguous(), loga, loga, sched)
    Cyy = _cost(y, y)
    f_bb, _ = _sinkhorn_potentials(Cyy, Cyy.transpose(1, 2).contiguous(), logb, logb, sched)

    a, b = loga.exp(), logb.exp()
    return (a * (f_ab - f_aa)).sum(dim=-1) + (b * (g_ab - f_bb)).sum(dim=-1)
