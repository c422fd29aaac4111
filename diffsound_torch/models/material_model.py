"""Trainable material parameterization: bin-weighted Young's modulus and
Poisson ratio.

E is a softplus-weighted convex combination over 16 log-spaced bins
spanning [E0/10, E0*10]; nu over 16 linear bins in [0.01, 0.499], or a
single frozen bin in the "mat_baseline" ablation.  Parameters are a dict of
float32 leaf tensors (float32 even when the model runs in float64, as in the
JAX package).  Counterpart of `diffsound_tpu/models/material_model.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..audio.oscillator import cached_values, uniform, weighted_value
from ..fem.material import Material, lame_params

PARAM_DTYPE = torch.float32


@dataclass(frozen=True)
class MaterialBins:
    mat: Material
    bin_num: int = 16
    learn_poisson: bool = True
    youngs_values: np.ndarray = field(default=None)
    poisson_values: np.ndarray = field(default=None)
    # bin values as tensors, per (name, dtype, device): a fresh copy from
    # host memory in every step would make the host wait for the device
    _tensors: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        yv = np.exp(
            np.linspace(
                np.log(self.mat.youngs / 10), np.log(self.mat.youngs * 10), self.bin_num
            )
        )
        pv = (
            np.linspace(0.01, 0.499, self.bin_num)
            if self.learn_poisson
            else np.asarray([self.mat.poisson])
        )
        object.__setattr__(self, "youngs_values", yv)
        object.__setattr__(self, "poisson_values", pv)

    def init_params(self, generator: torch.Generator, device="cpu"):
        """Logits uniform in [-1, 1), drawn from `generator`."""
        return {
            "youngs_logits": uniform(generator, self.bin_num, -1.0, 1.0, PARAM_DTYPE).to(device),
            "poisson_logits": uniform(generator, len(self.poisson_values), -1.0, 1.0,
                                      PARAM_DTYPE).to(device),
        }

    def _values(self, name, logits):
        return cached_values(self._tensors, name, getattr(self, name), logits)

    def youngs(self, params):
        lg = params["youngs_logits"]
        return weighted_value(lg, self._values("youngs_values", lg))

    def poisson(self, params):
        lg = params["poisson_logits"]
        return weighted_value(lg, self._values("poisson_values", lg))

    def lame(self, params, density_normalized: bool = True):
        """(mu, lambda); by default nondimensionalized by density (E/rho) —
        eigenvalues of (K/rho, M/rho) equal those of (K, M)."""
        E = self.youngs(params)
        nu = self.poisson(params)
        if density_normalized:
            E = E / self.mat.density
        return lame_params(E, nu)

    def trainable_keys(self):
        return (
            ("youngs_logits", "poisson_logits")
            if self.learn_poisson
            else ("youngs_logits",)
        )

    def mask_grads(self, params):
        """Zero the gradients of frozen parameters in place (only `youngs`
        trains in the mat_baseline ablation; Adam would otherwise amplify
        the ~0 noise gradient on the frozen single-bin poisson logit)."""
        keys = self.trainable_keys()
        for k, v in params.items():
            if k not in keys and v.grad is not None:
                v.grad.zero_()

    def pretrain(self, params, steps: int = 5000, lr: float = 5e-3):
        """Fit the bin logits so the weighted values hit the table's
        (E, nu) before inference starts (Adam projection, exact=False: the
        exact two-bin placement would leave every other logit at -18 where
        softplus gradients are ~1e-8)."""
        return self.fit_to(params, self.mat.youngs, self.mat.poisson,
                           steps=steps, lr=lr, exact=False)

    def exact_logits(self, target: float, values: np.ndarray, dtype=PARAM_DTYPE,
                     device="cpu"):
        """Closed-form logits whose softplus-normalized convex combination
        equals `target` exactly: weight split between the two bracketing
        bins, every other bin at softplus(-18) ~ 1.5e-8."""
        v = np.asarray(values, np.float64)
        n = len(v)
        t = float(np.clip(target, v.min(), v.max()))
        if n == 1:
            return torch.zeros(1, dtype=dtype, device=device)
        i = int(np.clip(np.searchsorted(v, t) - 1, 0, n - 2))
        floor = 1.5e-8  # softplus(-18)
        w = np.full(n, floor)
        # solve a v_i + b v_{i+1} = t - S with a + b = 1 - F, where F/S are
        # the floor bins' total weight/value mass
        F = floor * (n - 2)
        S = floor * (float(np.sum(v)) - v[i] - v[i + 1])
        a = ((1.0 - F) * v[i + 1] - (t - S)) / (v[i + 1] - v[i])
        a = float(np.clip(a, floor, 1.0 - F - floor))
        w[i], w[i + 1] = a, (1.0 - F) - a
        logits = np.log(np.expm1(np.maximum(w, 1e-12)))
        return torch.as_tensor(logits, dtype=dtype, device=device)

    def fit_to(self, params, youngs: float, poisson: float,
               steps: int = 300, lr: float = 2e-3, exact: bool = True):
        """Project explicit (E, nu) values onto the bin logits.

        exact=True: closed-form two-bin placement, then a short Adam polish.
        exact=False: Adam only, from the incoming logits (keeps every bin's
        logit in the responsive range for later training).  Returns a new
        params dict of detached leaf tensors."""
        p = {k: v.detach().clone() for k, v in params.items()}
        if exact:
            lg = p["youngs_logits"]
            p["youngs_logits"] = self.exact_logits(
                youngs, self.youngs_values, lg.dtype, lg.device
            )
            if self.learn_poisson:
                p["poisson_logits"] = self.exact_logits(
                    poisson, self.poisson_values, lg.dtype, lg.device
                )
        for v in p.values():
            v.requires_grad_(True)
        opt = torch.optim.Adam(list(p.values()), lr=lr)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            ly = (self.youngs(p) - youngs) ** 2 / youngs**2
            lp = (self.poisson(p) - poisson) ** 2 / poisson**2
            (ly + lp).backward()
            opt.step()
        return {k: v.detach() for k, v in p.items()}
