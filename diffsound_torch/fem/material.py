"""Material tables, isotropic linear elasticity and a learned stress model.

MatSet rows are (density, Young's modulus, Poisson ratio, Rayleigh alpha,
Rayleigh beta).  Isotropy means K = mu * K_mu + lambda * K_lam with
material-independent element blocks (see `fem.assembly`), so material
gradients flow through the two Lame scalars.  `linear_stress` and `TinyNN`
drive the general stress path (`assembly.k_matvec_stress`).
"""

import math
from dataclasses import dataclass

import torch
from torch import nn


class MatSet:
    """(density, youngs, poisson, alpha, beta) material table."""

    Ceramic = 2700, 7.2e10, 0.19, 6, 1e-7
    Glass = 2600, 6.2e10, 0.20, 1, 1e-7
    Wood = 750, 1.1e10, 0.25, 60, 2e-6
    Plastic = 1070, 1.4e9, 0.35, 30, 1e-6
    Iron = 8000, 2.1e11, 0.28, 10, 1e-7
    Polycarbonate = 1190, 2.4e9, 0.37, 0.5, 4e-7
    Steel = 7850, 2.0e11, 0.29, 20, 3e-8
    Tin = 7265, 5e10, 0.325, 2, 3e-8
    Test = 2700, 6e10, 0.19, 6, 1e-7
    RandomMin = 2700, 1e10, 0.1, 6, 1e-7
    RandomMax = 2700, 1e11, 0.4, 6, 1e-7


@dataclass(frozen=True)
class Material:
    density: float
    youngs: float
    poisson: float
    alpha: float
    beta: float

    @staticmethod
    def of(spec) -> "Material":
        """Accept a MatSet tuple, a name string, or a Material."""
        if isinstance(spec, Material):
            return spec
        if isinstance(spec, str):
            spec = getattr(MatSet, spec)
        d, e, p, a, b = spec
        return Material(float(d), float(e), float(p), float(a), float(b))


def lame_params(youngs, poisson):
    """(mu, lambda) from (E, nu); floats or tensors."""
    lam = youngs * poisson / ((1 + poisson) * (1 - 2 * poisson))
    mu = youngs / (2 * (1 + poisson))
    return mu, lam


def linear_stress(F, youngs, poisson):
    """Piola stress sigma = mu (F + F^T) + lambda tr(F) I for F (..., 3, 3)."""
    mu, lam = lame_params(youngs, poisson)
    tr = F.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    return mu * (F + F.transpose(-1, -2)) + lam * tr * eye


def elasticity_tensor(youngs, poisson, dtype=torch.float64, device="cpu"):
    """9x9 d(sigma)/d(F) with row-major (i,j) vec layout:
    C[(i,j),(k,l)] = mu (delta_ik delta_jl + delta_il delta_jk)
                   + lambda delta_ij delta_kl."""
    mu, lam = lame_params(youngs, poisson)
    eye = torch.eye(3, dtype=dtype, device=device)
    c = mu * (
        torch.einsum("ik,jl->ijkl", eye, eye) + torch.einsum("il,jk->ijkl", eye, eye)
    ) + lam * torch.einsum("ij,kl->ijkl", eye, eye)
    return c.reshape(9, 9)


class TinyNN(nn.Module):
    """Learned stress model: a 3-layer MLP F(9) -> sigma(9) with a tanh
    output scaled by `stress_scale` (so the squashing acts on O(1) values).
    Its parameters w1 (9, m), b1, w2 (m, m), b2, w3 (m, 9), b3 take the
    JAX package's names and layout: `load_state_dict` of its numpy params
    reproduces its model.  Initialised from `generator` (He-normal)."""

    def __init__(self, mid_dim: int = 32, non_linear: bool = True,
                 stress_scale: float = 1.0, generator=None, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.mid_dim = mid_dim
        self.non_linear = non_linear
        self.stress_scale = stress_scale
        m = mid_dim
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def normal(shape, fan):
            w = torch.randn(shape, generator=gen, dtype=torch.float64) * math.sqrt(fan)
            return nn.Parameter(w.to(dtype=dtype, device=device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))

        self.w1, self.b1 = normal((9, m), 2.0 / 9), zeros(m)
        self.w2, self.b2 = normal((m, m), 2.0 / m), zeros(m)
        self.w3, self.b3 = normal((m, 9), 1.0 / m), zeros(9)

    def stress(self, F):
        """F (..., 3, 3) -> sigma (..., 3, 3)."""
        x = F.reshape(*F.shape[:-2], 9)
        x = x @ self.w1 + self.b1
        if self.non_linear:
            x = torch.relu(x)
        x = x @ self.w2 + self.b2
        if self.non_linear:
            x = torch.relu(x)
        x = x @ self.w3 + self.b3
        x = torch.tanh(x) * self.stress_scale
        return x.reshape(*F.shape[:-2], 3, 3)

    forward = stress

    def stress_fn(self):
        return self.stress

    def jacobian_F(self, dtype=torch.float64):
        """9x9 elasticity tensor d(sigma)/d(F) at F = 0, with the weights
        cast to `dtype` (torch.func.jacrev)."""
        params = {k: v.detach().to(dtype) for k, v in self.named_parameters()}

        def flat(f9):
            return torch.func.functional_call(self, params, (f9.reshape(3, 3),)).reshape(9)

        return torch.func.jacrev(flat)(torch.zeros(9, dtype=dtype, device=self.w1.device))
