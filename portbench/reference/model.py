"""Plain reference of the multi-pair material_sync step (torch, float64).

Per pair b, with bin logits (youngs (16,), poisson (16,)):

    E_b  = sum_k softplus(l_k) v_k / sum_k softplus(l_k)   (16 log bins, E0/10 .. 10 E0)
    nu_b = the same over 16 linear bins in [0.01, 0.499]
    mu, lam = Lame(E_b / rho, nu_b)
    lam~_j = theta_j + mu q_mu,j + lam q_lam,j - theta_j q_m,j   (q: the basis' forms)
    f_j = sqrt(max(lam~_j, 1e-3)) / 2 pi   for the modes past the rigid ones
    d_j = (alpha + beta (2 pi f_j)^2) / 2,  fd_j = sqrt(max((2 pi f_j)^2 - d_j^2, 1e-12)) / 2 pi
    s[t] = sum_j exp(-d_j (t+1)/sr) sin(2 pi fd_j (t+1)/sr),  then the force convolution
    loss_b = sum over n_fft of  L1w(log2(S_p + eps), log2(S_t + eps)) + L1w(S_p, S_t)

S the power spectrogram (periodic Hann, centred frames with reflection,
hop n_fft/4), L1w the mean absolute error without the DC bin and with
frame weights w = 1 - linspace(1, 0.9) scaled to mean 1.  Adam (0.9,
0.999, eps 1e-8) on each leaf.  Nothing here reads the measured program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-7


def bin_values(mat, bins: int = 16):
    """(youngs bin values, poisson bin values) of the init material
    (density, E, nu, alpha, beta)."""
    E0 = float(mat[1])
    yv = np.exp(np.linspace(np.log(E0 / 10.0), np.log(E0 * 10.0), bins))
    return yv, np.linspace(0.01, 0.499, bins)


def weighted(logits: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    w = F.softplus(logits)
    return (w * values).sum(-1) / w.sum(-1)


def lame(E, nu):
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def material(params: dict, values) -> tuple:
    """(E (B,), nu (B,)) of the logits."""
    return weighted(params["youngs_logits"], values[0]), weighted(params["poisson_logits"], values[1])


def synth(freq: torch.Tensor, damp: torch.Tensor, T: int, sr: float) -> torch.Tensor:
    """(B, M) damped frequencies and dampings -> (B, T), unit amplitudes."""
    t = torch.arange(1, T + 1, dtype=freq.dtype, device=freq.device) / sr
    ph = 2.0 * math.pi * freq[..., None] * t
    return (torch.exp(-damp[..., None] * t) * torch.sin(ph)).sum(-2)


def convolve(sig: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """Causal convolution of each row with the force (F,), cut to T."""
    T, Fn = sig.shape[-1], force.shape[-1]
    n = 1 << (T + Fn - 2).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(sig, n=n) * torch.fft.rfft(force, n=n), n=n)
    return out[..., :T]


def signals(freqs: torch.Tensor, mat, cfg: dict, force: torch.Tensor) -> torch.Tensor:
    """Undamped frequencies (B, M) -> the synthesized (B, T) signals."""
    alpha, beta = float(mat[3]), float(mat[4])
    lbd = (2.0 * math.pi * freqs) ** 2
    d = 0.5 * (alpha + beta * lbd)
    fd = torch.sqrt(torch.clamp(lbd - d * d, min=1e-12)) / (2.0 * math.pi)
    return convolve(synth(fd, d, int(cfg["frame_num"]), float(cfg["sample_rate"])), force)


def power_spec(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, T) -> (B, n_fft/2 + 1, frames) |STFT|^2."""
    hop = n_fft // 4
    xp = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)  # (B, frames, n_fft)
    k = torch.arange(n_fft, dtype=x.dtype, device=x.device)
    win = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)
    X = torch.fft.rfft(frames * win, dim=-1)
    return (X.real ** 2 + X.imag ** 2).transpose(1, 2)


def _l1w(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = p.shape[-1]
    w = 1.0 - torch.linspace(1.0, 0.9, T, dtype=p.dtype, device=p.device)
    w = w / w.sum() * T
    return ((p[:, 1:] - t[:, 1:]).abs() * w).mean(dim=(1, 2))


def losses(sig: torch.Tensor, gt: torch.Tensor, n_ffts) -> torch.Tensor:
    """Per-row 5-scale L1 (B,)."""
    total = 0.0
    for n in n_ffts:
        sp, st = power_spec(sig, n), power_spec(gt, n)
        total = total + _l1w(torch.log2(sp + EPS), torch.log2(st + EPS)) + _l1w(sp, st)
    return total


def forms(el, U: torch.Tensor) -> torch.Tensor:
    """(3, k): diag(U^T K_mu U), diag(U^T K_lam U), diag(U^T M U)."""
    from .fem import apply_k_parts, apply_m

    kmu, klam = apply_k_parts(el, U)
    return torch.stack([(U * kmu).sum(0), (U * klam).sum(0), (U * apply_m(el, U)).sum(0)])


def frequencies(params, theta, q, mat, values, extra: int) -> torch.Tensor:
    """Undamped frequencies (B, M) from eigenvalues theta (B, k) and forms
    q (3, B, k) or (3, k) of the basis."""
    E, nu = material(params, values)
    mu, lam = lame(E / float(mat[0]), nu)
    lt = theta + mu[:, None] * q[0] + lam[:, None] * q[1] - theta * q[2]
    return torch.sqrt(torch.clamp(lt[:, extra:], min=1e-3)) / (2.0 * math.pi)


class Adam:
    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            out[k] = p - self.lr * mh / (vh.sqrt() + self.eps)
        return out


def follow(el, inputs: dict, cfg: dict, steps: int, pinned=None) -> dict:
    """The first `steps` steps from the benchmark's inputs, all in float64
    on el's device: the cold basis (theta (k,), U (3V, k)), the targets
    (B, T), the init logits, the force.  pinned: optional per-step (B, M)
    frequencies whose values replace the reference's own, which keep
    their derivative in the logits (value of the one, gradient of the
    other).  Returns per step the losses (B,) and the reference's own
    frequencies (`free_freqs`), the first gradient, and the params before
    and after each step (dicts of (B, 16))."""
    dev, dt = el.tets.device, torch.float64
    mat = cfg["init_material"]
    values = tuple(torch.as_tensor(v, dtype=dt, device=dev) for v in bin_values(mat))
    theta = torch.as_tensor(inputs["theta"], dtype=dt, device=dev)[None]
    q = forms(el, torch.as_tensor(inputs["basis"], dtype=dt, device=dev))
    gt = torch.as_tensor(inputs["targets"], dtype=dt, device=dev)
    force = torch.as_tensor(inputs["force"], dtype=dt, device=dev)
    params = {k: torch.as_tensor(v, dtype=dt, device=dev) for k, v in inputs["logits"].items()}
    opt = Adam(params, float(cfg["lr"]))
    out = {"losses": [], "free_freqs": [], "params": [params]}
    for s in range(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        freqs = frequencies(p, theta, q, mat, values, int(cfg["extra_modes"]))
        out["free_freqs"].append(freqs.detach())
        if pinned is not None:
            pin = torch.as_tensor(pinned[s], dtype=dt, device=dev)
            freqs = pin + (freqs - freqs.detach())
        sig = signals(freqs, mat, cfg, force)
        ls = losses(sig, gt, cfg["n_ffts"])
        grads = dict(zip(p, torch.autograd.grad(ls.sum(), list(p.values()))))
        if s == 0:
            out["grad"] = {k: g.detach() for k, g in grads.items()}
        out["losses"].append(ls.detach())
        params = opt.step({k: v.detach() for k, v in p.items()}, grads)
        out["params"].append(params)
    return out


def material_lame(params: dict, mat) -> tuple:
    """(mu (B,), lam (B,)) density-normalized, of float64 logits."""
    dev = params["youngs_logits"].device
    values = tuple(torch.as_tensor(v, dtype=torch.float64, device=dev) for v in bin_values(mat))
    E, nu = material(params, values)
    return lame(E / float(mat[0]), nu)
