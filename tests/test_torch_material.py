"""Parity of the port's MaterialBins with the JAX package: weighted values,
Lame parameters and their gradients, the closed-form logits, and the Adam
projections (fit_to / pretrain) to rtol 1e-5 in E and nu."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.fem.material import Material as JMaterial
from diffsound_tpu.models.material_model import MaterialBins as JBins

from diffsound_torch.convert import params_from_jax
from diffsound_torch.fem.material import Material, MatSet, lame_params
from diffsound_torch.models.material_model import MaterialBins

torch.set_num_threads(2)

MAT = (2700, 7.2e10, 0.19, 6, 1e-7)


def _pair(learn_poisson=True, seed=0):
    jb = JBins(JMaterial.of(MAT), learn_poisson=learn_poisson)
    tb = MaterialBins(Material.of(MAT), learn_poisson=learn_poisson)
    pj = jb.init_params(jax.random.PRNGKey(seed))
    return jb, tb, pj, {k: np.asarray(v) for k, v in pj.items()}


def test_tables_and_lame():
    assert Material.of("Ceramic") == Material.of(MatSet.Ceramic)
    mu, lam = lame_params(7.2e10, 0.19)
    np.testing.assert_allclose(mu, 7.2e10 / 2.38)
    np.testing.assert_allclose(lam, 7.2e10 * 0.19 / (1.19 * 0.62))


@pytest.mark.parametrize("learn_poisson", [True, False])
def test_values_and_lame_grads_f64(learn_poisson):
    jb, tb, _, pn = _pair(learn_poisson, seed=1)
    p64 = {k: v.astype(np.float64) for k, v in pn.items()}
    np.testing.assert_array_equal(tb.youngs_values, jb.youngs_values)
    np.testing.assert_array_equal(tb.poisson_values, jb.poisson_values)

    def f_j(p):
        mu, lam = jb.lame(p)
        return mu + 2.0 * lam, (jb.youngs(p), jb.poisson(p))

    (vj, (ej, nj)), gj = jax.value_and_grad(f_j, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p64.items()}
    )
    pt = params_from_jax(p64, dtype=torch.float64)
    for v in pt.values():
        v.requires_grad_(True)
    mu, lam = tb.lame(pt)
    vt = mu + 2.0 * lam
    gt = torch.autograd.grad(vt, list(pt.values()))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    np.testing.assert_allclose(float(tb.youngs(pt)), float(ej), rtol=1e-12)
    np.testing.assert_allclose(float(tb.poisson(pt)), float(nj), rtol=1e-12)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in gj.values())
    for g, k in zip(gt, pt):  # (a frozen single bin has a roundoff-only gradient)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), rtol=1e-10,
                                   atol=1e-12 * scale)


def test_exact_logits_match():
    jb, tb, _, _ = _pair()
    for target, values in ((3.3e10, jb.youngs_values), (0.27, jb.poisson_values),
                           (1e9, jb.youngs_values)):
        np.testing.assert_allclose(
            tb.exact_logits(target, values).numpy(),
            np.asarray(jb.exact_logits(target, values, jnp.float32)), rtol=1e-6,
        )


@pytest.mark.parametrize("exact,steps", [(True, 300), (False, 600)])
def test_fit_to_matches_jax(exact, steps):
    jb, tb, pj, pn = _pair(seed=2)
    target = (4.1e10, 0.31)
    fj = jb.fit_to(pj, *target, steps=steps, exact=exact)
    ft = tb.fit_to(params_from_jax(pn), *target, steps=steps, exact=exact)
    np.testing.assert_allclose(float(tb.youngs(ft)), float(jb.youngs(fj)), rtol=1e-5)
    np.testing.assert_allclose(float(tb.poisson(ft)), float(jb.poisson(fj)), rtol=1e-5)
    if exact:
        np.testing.assert_allclose(float(tb.youngs(ft)), target[0], rtol=1e-4)
        np.testing.assert_allclose(float(tb.poisson(ft)), target[1], rtol=1e-4)


def test_pretrain_matches_jax():
    jb, tb, pj, pn = _pair(seed=3)
    fj = jb.pretrain(pj)
    ft = tb.pretrain(params_from_jax(pn))
    np.testing.assert_allclose(float(tb.youngs(ft)), float(jb.youngs(fj)), rtol=1e-5)
    np.testing.assert_allclose(float(tb.poisson(ft)), float(jb.poisson(fj)), rtol=1e-5)
    assert all(v.dtype == torch.float32 and not v.requires_grad for v in ft.values())


def test_mask_grads_zeroes_frozen_poisson():
    tb = MaterialBins(Material.of(MAT), learn_poisson=False)
    p = tb.init_params(torch.Generator().manual_seed(0))
    for v in p.values():
        v.requires_grad_(True)
    mu, lam = tb.lame(p)
    (mu + lam).backward()
    tb.mask_grads(p)
    assert float(p["poisson_logits"].grad.abs().sum()) == 0.0
    assert float(p["youngs_logits"].grad.abs().sum()) > 0.0
