"""Parity of the port's neural SDF (diffsound_torch.geometry.sdf_mlp) with
the JAX package's flax model, in float64 on the CPU at narrow widths
(hidden 32): the network and the deformed-grid SDF through
`convert.sdf_params_from_jax` (rtol 1e-12; the deformed grid to 1e-14, as
tanh differs by an ulp), the voxel hinge and its gradient (rtol 1e-10), a
few full-batch pretraining Adam steps against optax (rtol 1e-9 on the
parameters), one regression step on a given batch against optax plus the
loss decrease of `train_sdf_regression`, flax's initialisation statistics,
and the voxel occupancy and boundary faces exactly (face order included,
cavities too)."""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.geometry import sdf_mlp as jsdf
from diffsound_tpu.geometry.geometry_task import GeometryTask as JTask
from diffsound_tpu.geometry.grid import generate_background_grid

from diffsound_torch.convert import sdf_params_from_jax
from diffsound_torch.geometry import sdf_mlp as tsdf
from diffsound_torch.geometry.geometry_task import GeometryTask as TTask

torch.set_num_threads(2)

GRID, HIDDEN = 8, 32


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(g_t, g_j, rtol):
    """The port's params-shaped gradient against JAX's, leaf by leaf."""
    dense = g_j["mlp"]["params"]
    for i in range(len(dense)):
        for name, jv in (("weight", np.asarray(dense[f"Dense_{i}"]["kernel"]).T),
                         ("bias", np.asarray(dense[f"Dense_{i}"]["bias"]))):
            tv = g_t["mlp"][f"layers.{i}.{name}"].detach().numpy()
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=rtol * np.abs(jv).max() + 1e-300,
                                       err_msg=f"layer {i} {name}")
    jd = np.asarray(g_j["deform"])
    np.testing.assert_allclose(g_t["deform"].detach().numpy(), jd, rtol=rtol,
                               atol=rtol * np.abs(jd).max() + 1e-300)


@pytest.fixture(scope="module")
def geos():
    gverts, _ = generate_background_grid(GRID)
    gverts = gverts.astype(np.float64) * 1.2
    jgeo = jsdf.SDFGeometry(gverts, GRID, 1.2, freq_num=2, hidden_dim=HIDDEN)
    tgeo = tsdf.SDFGeometry(gverts, GRID, 1.2, freq_num=2, hidden_dim=HIDDEN, device="cpu")
    jp = _f64(jgeo.init_params(jax.random.PRNGKey(3)))
    # a non-zero deform, so the tanh bound is exercised
    jp["deform"] = jnp.asarray(np.random.default_rng(3).normal(size=gverts.shape))
    tp = sdf_params_from_jax(*(lambda n: (n["mlp"], n["deform"]))(_np(jp)))
    return jgeo, tgeo, jp, tp


def test_sdf_net_and_geometry_match_flax(geos):
    jgeo, tgeo, jp, tp = geos
    assert list(tp["mlp"]) == [f"layers.{i}.{n}" for i in range(5) for n in ("weight", "bias")]
    x = np.random.default_rng(0).uniform(-0.6, 0.6, (200, 3))
    want = np.asarray(jgeo.net.apply(jp["mlp"], jnp.asarray(x)))
    got = tgeo.net.evaluate(tp["mlp"], torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    enc_j = np.asarray(jsdf.PositionalEncoding(2, 1.2).apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(tsdf.PositionalEncoding(2, 1.2)(torch.as_tensor(x)).numpy(),
                               enc_j, rtol=1e-15, atol=1e-15)
    # tanh differs from XLA's by an ulp
    np.testing.assert_allclose(tgeo.deformed_verts(tp).numpy(),
                               np.asarray(jgeo.deformed_verts(jp)), rtol=1e-14, atol=1e-15)
    assert tgeo.deform_bound == jgeo.deform_bound
    np.testing.assert_allclose(tgeo.sdf(tp).numpy(), np.asarray(jgeo.sdf(jp)),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("margin", [0.0, 0.05])
def test_mesh_template_loss_and_gradient_match_jax(geos, margin):
    jgeo, tgeo, jp, tp = geos
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.5, 0.5, (600, 3))
    sd = 0.3 - np.linalg.norm(q, axis=1)
    lj, gj = jax.value_and_grad(
        lambda p: jgeo.mesh_template_loss(p, jnp.asarray(q), jnp.asarray(sd), margin))(jp)
    p = {"mlp": {k: v.clone().requires_grad_(True) for k, v in tp["mlp"].items()},
         "deform": tp["deform"].clone().requires_grad_(True)}
    lt = tgeo.mesh_template_loss(p, torch.as_tensor(q), torch.as_tensor(sd), margin)
    assert float(lj) > 0
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-12)
    g = torch.autograd.grad(lt, [*p["mlp"].values()])
    g = {"mlp": dict(zip(p["mlp"], g)), "deform": torch.zeros_like(p["deform"])}
    _grads_close(g, gj, 1e-10)


def test_pretrain_sdf_adam_steps_match_optax():
    """Five full-batch Adam steps of the hinge (lr 1e-3) from the same
    float64 params in both packages."""
    jt = JTask(grid_res=GRID, mode_num=4, tets_dir="/nonexistent", freq_num=1)
    jt.geo = jsdf.SDFGeometry(jt.grid_verts, GRID, 1.0, 1, hidden_dim=HIDDEN)
    tt = TTask(grid_res=GRID, mode_num=4, tets_dir="/nonexistent", freq_num=1, device="cpu")
    tt.geo = tsdf.SDFGeometry(tt.grid_verts, GRID, 1.0, 1, hidden_dim=HIDDEN, device="cpu")
    jp = _f64(jt.init_params(jax.random.PRNGKey(0)))
    n = _np(jp)
    tp = sdf_params_from_jax(n["mlp"], n["deform"])
    rng = np.random.default_rng(0)
    q = rng.uniform(-0.5, 0.5, (800, 3))
    sd = 0.35 - np.linalg.norm(q, axis=1)
    jp = jt.pretrain_sdf(jp, q, sd, iters=5, lr=1e-3)
    tp = tt.pretrain_sdf(tp, q, sd, iters=5, lr=1e-3)
    g = {"mlp": tp["mlp"], "deform": tp["deform"]}
    _grads_close(g, _np(jp), 1e-9)  # the parameters, leaf by leaf
    assert not any(v.requires_grad for v in tp["mlp"].values())


def test_pretrain_sdf_stops_at_zero_loss():
    """A constraint the start already satisfies has loss 0: one step."""
    tt = TTask(grid_res=GRID, mode_num=4, tets_dir="/nonexistent", freq_num=1, device="cpu")
    tt.geo = tsdf.SDFGeometry(tt.grid_verts, GRID, 1.0, 1, hidden_dim=HIDDEN, device="cpu")
    p = tt.init_params(torch.Generator().manual_seed(0))
    q = np.random.default_rng(0).uniform(-0.5, 0.5, (100, 3))
    with torch.no_grad():
        pred = tt.geo.sdf_at(p, torch.as_tensor(q)).numpy()
    steps = []
    orig = torch.optim.Adam.step

    def counting_step(self, *a, **k):
        steps.append(1)
        return orig(self, *a, **k)

    torch.optim.Adam.step = counting_step
    try:
        tt.pretrain_sdf(p, q, np.sign(pred) * 0.1, iters=50, lr=1e-3)
    finally:
        torch.optim.Adam.step = orig
    assert len(steps) == 1


def test_regression_step_matches_optax_and_training_reduces_loss(geos):
    """train_sdf_regression draws its batches from a torch.Generator, the
    JAX package from jax.random, so one step is held to optax on a given
    batch (rtol 1e-9), and a run to its loss decrease."""
    jgeo, tgeo, jp, tp = geos
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, (300, 3))
    vals = 0.3 - np.linalg.norm(pts, axis=1)
    opt = optax.adam(1e-3)
    loss_j, g = jax.value_and_grad(
        lambda p: jnp.mean((jgeo.net.apply(p, jnp.asarray(pts)) - jnp.asarray(vals)) ** 2)
    )(jp["mlp"])
    upd, _ = opt.update(g, opt.init(jp["mlp"]))
    want = optax.apply_updates(jp["mlp"], upd)
    p = {k: v.clone().requires_grad_(True) for k, v in tp["mlp"].items()}
    topt = torch.optim.Adam(list(p.values()), lr=1e-3)
    loss_t = tsdf.regression_loss(tgeo.net, p, torch.as_tensor(pts), torch.as_tensor(vals))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-12)
    loss_t.backward()
    topt.step()
    _grads_close({"mlp": p, "deform": tp["deform"]}, {"mlp": _np(want), "deform": jp["deform"]},
                 1e-9)

    trained = tgeo.pretrain_regression(tp, pts * 1.2, vals, iters=150, lr=1e-3, batch=128)
    with torch.no_grad():
        before = tsdf.regression_loss(tgeo.net, tp["mlp"], torch.as_tensor(pts),
                                      torch.as_tensor(vals)).item()
        after = tsdf.regression_loss(tgeo.net, trained["mlp"], torch.as_tensor(pts),
                                     torch.as_tensor(vals)).item()
    assert after < 0.3 * before, (before, after)
    assert trained["deform"] is tp["deform"]


def test_init_params_follow_flax_statistics():
    """Truncated lecun-normal kernels (|w| <= 2 sigma / 0.8796, unit
    variance after the truncation) and zero biases, from the generator."""
    net = tsdf.SDFNet(freq_num=3, hidden_dim=256)
    p = net.init_params(torch.Generator().manual_seed(0))
    q = net.init_params(torch.Generator().manual_seed(0))
    for i, layer in enumerate(net.layers):
        w = p[f"layers.{i}.weight"]
        assert w.shape == (layer.out_features, layer.in_features)
        assert torch.equal(w, q[f"layers.{i}.weight"])
        assert not p[f"layers.{i}.bias"].any()
        sigma = math.sqrt(1.0 / layer.in_features)
        assert float(w.abs().max()) <= 2 * sigma / 0.87962566103423978
        if w.numel() > 1000:
            assert abs(float(w.std()) / sigma - 1) < 0.05
    assert net.layers[0].in_features == 21 and net.layers[0].weight.is_meta


@pytest.mark.parametrize("case", ["block", "cavity", "random"])
def test_voxel_occupancy_and_boundary_faces_exact(case):
    if case == "random":
        occ = np.random.default_rng(4).uniform(size=(6, 6, 6)) < 0.6
        res = 6
    else:
        occ = np.ones((3, 3, 3), bool)
        if case == "cavity":
            occ[1, 1, 1] = False
        res = 3
    coords = np.argwhere(occ)
    vj, tj = jsdf.voxel_boundary_faces(coords, res)
    vt, tt = tsdf.voxel_boundary_faces(coords, res)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    assert vt.dtype == vj.dtype and tt.dtype == tj.dtype
    if case != "random":
        assert len(tt) == 108  # the outer boundary only: 6 faces x 9 quads x 2
    sd = np.random.default_rng(5).normal(size=res**3)
    np.testing.assert_array_equal(tsdf.voxelize_occupancy(sd, res),
                                  jsdf.voxelize_occupancy(sd, res))
