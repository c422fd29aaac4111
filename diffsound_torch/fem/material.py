"""Material tables and isotropic linear elasticity.

MatSet rows are (density, Young's modulus, Poisson ratio, Rayleigh alpha,
Rayleigh beta).  Isotropy means K = mu * K_mu + lambda * K_lam with
material-independent element blocks (see `fem.assembly`), so material
gradients flow through the two Lame scalars.
"""

from dataclasses import dataclass


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
