"""The port's render layer (diffsound_torch.render) against the JAX package's
diffsound_tpu.render on the same seeded numpy inputs, on the CPU: the
functions' algebra in float64 (values to 1e-10, gradients to 1e-9 of their
largest entries), the rasterizer and `render_mesh` in float32 (the
render's dtype in both packages).  The FG table (to 1e-6), the
light's constant operators (exactly), the cubemap and bilinear fetches, the
environment light's shade and regularizer, the BSDFs, the MLP texture (from
JAX's weights), the rasterizer (tri_id pixel for pixel; u, v, zw and the
straight-through alpha within 1e-5; the gradient of a pixel-weighted loss
within 1e-4 relative), interpolation, `shade` with the jitter noise fed in,
the image-loss family, the mesh and regularizer helpers, and `render_mesh`
with two peeled layers and with spp 2.  Values and gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.render import bsdf as jbsdf
from diffsound_tpu.render import image_loss as jil
from diffsound_tpu.render import light as jlight
from diffsound_tpu.render import mesh as jmesh
from diffsound_tpu.render import rasterize as jras
from diffsound_tpu.render import regularizer as jreg
from diffsound_tpu.render import render as jrender
from diffsound_tpu.render import util as jutil
from diffsound_tpu.render.mlptexture import MLPTexture3D as JTex
from diffsound_tpu.render.texture import Texture2D as JTexture2D
from diffsound_tpu.render.texture import sample_bilinear as j_bilinear

from diffsound_torch.convert import joint_params_from_jax
from diffsound_torch.render import (
    bsdf, image_loss, light, mesh, rasterize, regularizer, render, util,
)
from diffsound_torch.render.mlptexture import MLPTexture3D
from diffsound_torch.render.texture import sample_bilinear
from diffsound_torch.utils.visualize import write_png

torch.set_num_threads(2)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _parity(jfn, tfn, inputs, rtol=1e-10, grad_rtol=1e-9, seed=0):
    """jfn and tfn on the same inputs, cast to float64: values within rtol
    (relative to the largest |value|), and the gradient of a random
    weighting of the output in every input within grad_rtol (relative to
    each gradient's largest entry)."""
    inputs = [np.asarray(x, np.float64) for x in inputs]
    jin = [jnp.asarray(x) for x in inputs]
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    jo, to = np.asarray(jfn(*jin)), tfn(*tin)
    assert to.dtype == torch.float64 and to.shape == jo.shape
    np.testing.assert_allclose(to.detach().numpy(), jo, rtol=0, atol=rtol * np.abs(jo).max())
    w = np.random.default_rng(seed).normal(size=jo.shape)
    gj = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(jin))))(*jin)
    gt = torch.autograd.grad((to * torch.as_tensor(w)).sum(), tin, allow_unused=True)
    for i, (a, b) in enumerate(zip(gt, gj)):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=grad_rtol * max(np.abs(b).max(), 1e-30),
                                   err_msg=f"input {i}")


# -- util, texture, light ----------------------------------------------------


def test_fg_lut_equals_jax_to_1e6(tmp_path, monkeypatch):
    monkeypatch.setattr(jlight, "_fg_lut_path", lambda: str(tmp_path / "none.npy"))
    want = jlight.fg_lut.__wrapped__()
    got = light._fg_lut_compute(256, 1024)
    assert got.dtype == np.float32 and got.shape == (256, 256, 2)
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_array_equal(light.fg_lut(), got)  # the cached table


@pytest.mark.parametrize("res", [4, 8])
def test_light_operators_equal_jax(res):
    np.testing.assert_array_equal(light._diffuse_operator(res), jlight._diffuse_operator(res))
    for r in (0.08, 0.3, 1.0):
        np.testing.assert_array_equal(light._ggx_operator(res, r), jlight._ggx_operator(res, r))
    for a, b in zip(util.cubemap_directions(res), jutil.cubemap_directions(res)):
        np.testing.assert_array_equal(a, b)


def test_sample_cubemap_and_bilinear():
    rng = np.random.default_rng(1)
    cube = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(40, 7, 3)).astype(np.float32)
    _parity(jutil.sample_cubemap, util.sample_cubemap, [cube, dirs])
    tex = rng.uniform(size=(5, 7, 2)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, size=(30, 2)).astype(np.float32)
    for clamp in (True, False):
        _parity(lambda t, u: j_bilinear(t, u, clamp), lambda t, u: sample_bilinear(t, u, clamp),
                [tex, uv])


@pytest.mark.parametrize("base_res", [16, 32])
def test_environment_light_shade_and_regularizer(base_res):
    """One mip at 16 (the joint config's: get_mip offsets by -1), two at 32."""
    rng = np.random.default_rng(base_res)
    jl, tl = jlight.EnvironmentLight(base_res), light.EnvironmentLight(base_res)
    assert tl.n_mips == jl.n_mips and tl._mip_roughness(0) == jl._mip_roughness(0)
    base = rng.uniform(0.1, 0.9, size=(6, base_res, base_res, 3)).astype(np.float32)
    n = (16, 3)
    pos = rng.normal(size=n).astype(np.float32) * 0.3
    nrm = _unit(rng, (16,))
    kd = rng.uniform(size=n).astype(np.float32)
    ks = np.stack([rng.uniform(0, 0.3, 16), rng.uniform(0.05, 1.0, 16), rng.uniform(size=16)],
                  -1).astype(np.float32)
    view = np.array([[0.3, 0.4, 2.5]], np.float32)
    for spec in (True, False):
        _parity(lambda b, p, q, d, s: jl.shade({"base": b}, p, q, d, s, view, spec),
                lambda b, p, q, d, s: tl.shade({"base": b}, p, q, d, s, torch.as_tensor(view),
                                               spec),
                [base, pos, nrm, kd, ks])
    _parity(lambda b: jl.regularizer({"base": b}), lambda b: tl.regularizer({"base": b}), [base])


# -- bsdf, MLP texture -------------------------------------------------------


def test_bsdfs_match_jax():
    rng = np.random.default_rng(2)
    n, wi, wo = _unit(rng, (64,)), _unit(rng, (64,)), _unit(rng, (64,))
    r = rng.uniform(0.05, 1.0, (64, 1)).astype(np.float32)
    col = rng.uniform(size=(64, 3)).astype(np.float32)
    _parity(jbsdf.lambert, bsdf.lambert, [n, wi])
    _parity(jbsdf.frostbite, bsdf.frostbite, [n, wi, wo, r])
    _parity(jbsdf.pbr_specular, bsdf.pbr_specular, [col, n, wo, wi, r])
    _parity(lambda *a: jbsdf.phong(*a, 8.0), lambda *a: bsdf.phong(*a, 8.0), [n, wo, wi])
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    arm = rng.uniform(size=(64, 3)).astype(np.float32)
    vp = np.array([0.1, 0.2, 3.0], np.float32)
    lp = np.array([2.0, 2.0, 2.0], np.float32)
    for diffuse in ("lambert", "frostbite"):
        _parity(lambda kd, a, p, q: jbsdf.pbr_bsdf(kd, a, p, q, vp, lp, diffuse=diffuse),
                lambda kd, a, p, q: bsdf.pbr_bsdf(kd, a, p, q, torch.as_tensor(vp),
                                                  torch.as_tensor(lp), diffuse=diffuse),
                [col, arm, pos, n])
    pert = rng.normal(size=(64, 3)).astype(np.float32)
    tng, geom = _unit(rng, (64,)), _unit(rng, (64,))
    _parity(lambda p, a, b, c, d: jbsdf.prepare_shading_normal(p, vp, a, b, c, d),
            lambda p, a, b, c, d: bsdf.prepare_shading_normal(p, torch.as_tensor(vp), a, b, c, d),
            [pos, pert, n, tng, geom])


def test_mlp_texture_from_jax_weights():
    aabb = (np.array([-0.6, -0.6, -0.6]), np.array([0.6, 0.6, 0.6]))
    jt, tt = JTex(aabb, hidden=32), MLPTexture3D(aabb, hidden=32)
    jp = jt.init_params(jax.random.PRNGKey(3))
    # float32 weights in both, applied to float64 positions (JAX promotes)
    tp = {k: v.double() for k, v in
          joint_params_from_jax({"tex": jax.tree.map(np.asarray, jp)})["tex"].items()}
    pos = np.random.default_rng(3).uniform(-0.5, 0.5, (50, 3))
    _parity(lambda x: jt.sample(jp, x), lambda x: tt.sample(tp, x), [pos])
    # the gradient in the weights
    w = np.random.default_rng(4).normal(size=(50, 9))
    gj = jax.grad(lambda p: jnp.sum(jt.sample(p, jnp.asarray(pos)) * w))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    gt = torch.autograd.grad((tt.sample(leaves, torch.as_tensor(pos)) * torch.as_tensor(w)).sum(),
                             list(leaves.values()))
    want = joint_params_from_jax({"tex": jax.tree.map(np.asarray, gj)})["tex"]
    for (name, b), a in zip(want.items(), gt):  # JAX's float32 gradient
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * b.abs().max().item(), err_msg=name)
    # the port's own init: He-normal weights of the same shapes
    init = tt.init_params(torch.Generator().manual_seed(0))
    assert [tuple(v.shape) for v in init.values()] == [tuple(v.shape) for v in tp.values()]


# -- rasterizer ----------------------------------------------------------------


def _scene(seed=0, V=15):
    """Random clip-space triangles, several overlapping, plus two masked
    (0, 0, 0) padding triangles."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.uniform(-0.9, 0.9, (V, 2)), rng.uniform(0.1, 0.9, (V, 1)),
                        rng.uniform(0.8, 1.5, (V, 1))], 1)
    v[:, :3] *= v[:, 3:]
    tris = np.concatenate([np.arange(V).reshape(-1, 3), [[0, 4, 8], [1, 5, 9], [2, 7, 12]],
                           np.zeros((2, 3), int)]).astype(np.int32)
    mask = np.ones(len(tris), bool)
    mask[-2:] = False
    return v.astype(np.float32), tris, mask


def _seam_counted_equal(a, b, n_pix):
    """tri_id pixel for pixel; a seam sample that float32 rounding order
    could flip is counted (at most 2 per 1,024 pixels).  Returns the
    agreeing pixels."""
    same = a == b
    assert (~same).sum() <= 2 * n_pix // 1024, (~same).sum()
    return same


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_two_layers_and_its_gradient(seed):
    v, tris, mask = _scene(seed)
    H = W = 32
    jl = jras.rasterize(jnp.asarray(v), jnp.asarray(tris), (H, W), tri_mask=jnp.asarray(mask),
                        num_layers=2)
    tl = rasterize.rasterize(torch.as_tensor(v), torch.as_tensor(tris), (H, W),
                             tri_mask=torch.as_tensor(mask), num_layers=2)
    for a, b in zip(jl, tl):
        ids = np.asarray(a.tri_id)
        assert (ids > 0).sum() > 50 and not np.isin(ids, [len(tris) - 1, len(tris)]).any()
        same = _seam_counted_equal(ids, b.tri_id.numpy(), H * W)
        for f in ("u", "v", "zw", "alpha_soft"):
            x, y = np.asarray(getattr(a, f))[same], getattr(b, f).numpy()[same]
            fin = np.isfinite(x)
            assert (np.isfinite(y) == fin).all()
            np.testing.assert_allclose(y[fin], x[fin], rtol=0, atol=1e-5, err_msg=f)
    w = np.random.default_rng(seed).normal(size=(H, W)).astype(np.float32)

    def jloss(vc):
        layers = jras.rasterize(vc, jnp.asarray(tris), (H, W), tri_mask=jnp.asarray(mask),
                                num_layers=2)
        return sum(jnp.sum(w * (r.u + 2 * r.v + r.zw * (r.tri_id > 0) + r.alpha_soft))
                   for r in layers)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    vt = torch.tensor(v, requires_grad=True)
    layers = rasterize.rasterize(vt, torch.as_tensor(tris), (H, W), tri_mask=torch.as_tensor(mask),
                                 num_layers=2)
    wt = torch.as_tensor(w)
    loss = sum((wt * (r.u + 2 * r.v + torch.where(r.tri_id > 0, r.zw, 0.0) + r.alpha_soft)).sum()
               for r in layers)
    (gt,) = torch.autograd.grad(loss, vt)
    assert np.abs(gj).max() > 0
    assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def test_rasterize_chunks_and_soft_recompute():
    """A chunk of 8 (several chunks, a padded last one) gives the default
    chunk's result, and the soft channel's recomputed backward equals
    autograd through the forward."""
    v, tris, mask = _scene(2, V=30)
    args = (torch.as_tensor(tris), (24, 24))
    big = rasterize.rasterize(torch.as_tensor(v), *args, tri_mask=torch.as_tensor(mask))[0]
    small = rasterize.rasterize(torch.as_tensor(v), *args, tri_mask=torch.as_tensor(mask),
                                chunk=8)[0]
    assert torch.equal(big.tri_id, small.tri_id) and torch.equal(big.alpha_soft, small.alpha_soft)
    corners = torch.tensor(v[tris[:8]], requires_grad=True)
    px, py = rasterize._pixel_grid(24, 24, "cpu")
    m = torch.as_tensor(mask[:8])
    zf = torch.full((24, 24), -float("inf"))
    out = rasterize._Chunk.apply(corners, m, px, py, zf, 1.0)[0]
    w = torch.randn(24, 24, generator=torch.Generator().manual_seed(0))
    (g1,) = torch.autograd.grad((out * w).sum(), corners)
    ref = rasterize._soft(*rasterize._edges(corners, m, px, py), 24, 24, 1.0)
    (g2,) = torch.autograd.grad((ref * w).sum(), corners)
    assert torch.equal(out, ref.detach()) and torch.equal(g1, g2)


def test_interpolate_and_interpolate_face():
    v, tris, mask = _scene(3)
    jr = jras.rasterize(jnp.asarray(v), jnp.asarray(tris), (32, 32), tri_mask=jnp.asarray(mask))[0]
    tr = rasterize.rasterize(torch.as_tensor(v), torch.as_tensor(tris), (32, 32),
                             tri_mask=torch.as_tensor(mask))[0]
    rng = np.random.default_rng(3)
    attr = rng.normal(size=(len(v), 5)).astype(np.float32)
    face = rng.normal(size=(len(tris), 2)).astype(np.float32)
    _parity(lambda a: jras.interpolate(a, jr, jnp.asarray(tris)),
            lambda a: rasterize.interpolate(a, tr, torch.as_tensor(tris)), [attr])
    _parity(lambda f: jras.interpolate_face(f, jr), lambda f: rasterize.interpolate_face(f, tr),
            [face])


# -- shade, image loss ---------------------------------------------------------


def test_shade_mlp_branch_with_the_jitter_noise():
    rng = np.random.default_rng(5)
    aabb = (np.array([-0.6] * 3), np.array([0.6] * 3))
    jt, tt = JTex(aabb, hidden=16), MLPTexture3D(aabb, hidden=16)
    jp = jt.init_params(jax.random.PRNGKey(5))
    tp = {k: v.double() for k, v in
          joint_params_from_jax({"tex": jax.tree.map(np.asarray, jp)})["tex"].items()}
    jl, tl = jlight.EnvironmentLight(16), light.EnvironmentLight(16)
    base = rng.uniform(0.1, 0.9, size=(6, 16, 16, 3))
    shape = (6, 5)
    pos = rng.uniform(-0.4, 0.4, shape + (3,))
    nrm, geom = _unit(rng, shape), _unit(rng, shape)
    tng = np.broadcast_to(np.array([1.0, 0, 0]), shape + (3,)).copy()
    texc = rng.uniform(size=shape + (2,))
    view = np.array([0.3, 0.2, 2.7]).reshape(1, 1, 3)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, pos.shape, jnp.float64))
    keys = ("shaded", "kd_grad", "occlusion")
    _parity(lambda b, p, n: jnp.concatenate([jrender.shade(
                p, geom, n, tng, texc, view, jl, {"base": b}, {"kd_ks_normal": jt},
                {"kd_ks_normal": jp}, rng_key=key)[k] for k in keys], -1),
            lambda b, p, n: torch.cat([render.shade(
                p, torch.as_tensor(geom), n, torch.as_tensor(tng), torch.as_tensor(texc),
                torch.as_tensor(view), tl, {"base": b}, {"kd_ks_normal": tt},
                {"kd_ks_normal": tp}, noise=torch.as_tensor(noise))[k] for k in keys], -1),
            [base, pos, nrm])


class _Bilinear:
    """A one-mip texture of the port: the sampler the JAX package's
    Texture2D uses at one mip."""

    def sample(self, params, uv):
        return sample_bilinear(params, uv)


def test_shade_texture_branch_and_bsdf_modes():
    rng = np.random.default_rng(6)
    jl, tl = jlight.EnvironmentLight(16), light.EnvironmentLight(16)
    base = rng.uniform(0.1, 0.9, size=(6, 16, 16, 3))
    kd = rng.uniform(size=(8, 8, 4))
    ks = rng.uniform(size=(8, 8, 3))
    shape = (5, 4)
    pos = rng.uniform(-0.4, 0.4, shape + (3,))
    nrm, geom, tng = _unit(rng, shape), _unit(rng, shape), _unit(rng, shape)
    texc = rng.uniform(size=shape + (2,))
    view = np.array([0.3, 0.2, 2.7]).reshape(1, 1, 3)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, texc.shape, jnp.float64))
    jmat = {"kd": JTexture2D(kd, auto_mips=False), "ks": JTexture2D(ks, auto_mips=False)}
    tmat = {"kd": _Bilinear(), "ks": _Bilinear()}
    keys = ("shaded", "kd_grad", "occlusion")
    for bsdf_name in ("pbr", "diffuse", "normal", "tangent", "kd", "ks"):
        _parity(lambda b, a, c, p: jnp.concatenate([jrender.shade(
                    p, geom, nrm, tng, texc, view, jl, {"base": b}, jmat, {"kd": a, "ks": c},
                    bsdf_name, rng_key=key)[k] for k in keys], -1),
                lambda b, a, c, p: torch.cat([render.shade(
                    p, torch.as_tensor(geom), torch.as_tensor(nrm), torch.as_tensor(tng),
                    torch.as_tensor(texc), torch.as_tensor(view), tl, {"base": b}, tmat,
                    {"kd": a, "ks": c}, bsdf_name, noise=torch.as_tensor(noise))[k] for k in keys],
                    -1),
                [base, kd, ks, pos])


@pytest.mark.parametrize("loss", ["mse", "l1", "logl1", "smape", "relmse"])
@pytest.mark.parametrize("tonemapper", [None, "log_srgb"])
def test_image_loss_family(loss, tonemapper):
    rng = np.random.default_rng(7)
    img = rng.uniform(-0.1, 3.0, (6, 6, 3)).astype(np.float32)
    img[0, 0] = 0.0  # a black pixel: |x| and the clamp at their ties
    tgt = rng.uniform(0, 2.0, (6, 6, 3)).astype(np.float32)
    tgt[0, 0] = 0.0
    _parity(jil.make_image_loss(loss, tonemapper), image_loss.make_image_loss(loss, tonemapper),
            [img, tgt])
    with pytest.raises(ValueError):
        image_loss.make_image_loss("bogus")(torch.as_tensor(img), torch.as_tensor(tgt))


# -- mesh, regularizers, render_mesh --------------------------------------------


def _icosphere(sub=1, radius=0.5):
    from diffsound_torch.fem.mesh import icosphere

    v, f = icosphere(sub, radius)
    return v.astype(np.float32), f.astype(np.int32)


def test_mesh_normals_tangents_and_helpers():
    v, f = _icosphere(2)
    v = v * np.array([1.0, 0.8, 1.2], np.float32)
    rng = np.random.default_rng(8)
    uv = rng.uniform(size=(len(v), 2)).astype(np.float32)
    jm = jmesh.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f), v_tex=jnp.asarray(uv),
                    t_tex_idx=jnp.asarray(f))
    tm = mesh.Mesh(v_pos=torch.as_tensor(v), t_pos_idx=torch.as_tensor(f),
                   v_tex=torch.as_tensor(uv), t_tex_idx=torch.as_tensor(f))
    jn, tn = jmesh.auto_normals(jm), mesh.auto_normals(tm)
    np.testing.assert_allclose(tn.v_nrm.numpy(), np.asarray(jn.v_nrm), atol=1e-6)
    jt, tt = jmesh.compute_tangents(jn), mesh.compute_tangents(tn)
    np.testing.assert_allclose(tt.v_tng.numpy(), np.asarray(jt.v_tng), atol=2e-5)
    np.testing.assert_allclose(mesh.unit_size(tm).v_pos.numpy(),
                               np.asarray(jmesh.unit_size(jm).v_pos), atol=1e-6)
    ref = (np.array([-1.0, -0.5, -0.2], np.float32), np.array([0.5, 0.7, 0.9], np.float32))
    np.testing.assert_allclose(
        mesh.center_by_reference(tm, tuple(map(torch.as_tensor, ref)), 1.5).v_pos.numpy(),
        np.asarray(jmesh.center_by_reference(jm, tuple(map(jnp.asarray, ref)), 1.5).v_pos),
        atol=1e-6)
    np.testing.assert_array_equal(mesh.unique_edges(f), jmesh.unique_edges(f))
    _parity(lambda p: jmesh.face_normals(p, jnp.asarray(f)),
            lambda p: mesh.face_normals(p, torch.as_tensor(f)), [v])
    # the card's gather-sum transpose (exercised on the CPU by hand) sums the
    # same rows as index_add_
    rows = torch.randn(3 * len(f), 3, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    gidx = mesh.gather_index(f, len(v))
    padded = torch.cat([rows, rows.new_zeros(1, 3)])
    by_gather = padded[gidx].sum(1)
    torch.testing.assert_close(by_gather, mesh.vertex_sum(rows, torch.as_tensor(f), len(v)))


def test_regularizers_match_jax():
    v, f = _icosphere(2)
    rng = np.random.default_rng(9)
    v = v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
    _parity(lambda p: jreg.laplace_regularizer_const(p, jnp.asarray(f)),
            lambda p: regularizer.laplace_regularizer_const(p, torch.as_tensor(f)), [v])
    pairs = regularizer.edge_to_face_mapping(f)
    np.testing.assert_array_equal(pairs, jreg.edge_to_face_mapping(f))
    # an open mesh and a non-manifold edge
    f_open = np.concatenate([f[:-3], f[:2]])
    np.testing.assert_array_equal(regularizer.edge_to_face_mapping(f_open),
                                  jreg.edge_to_face_mapping(f_open))
    _parity(lambda p: jreg.normal_consistency(p, jnp.asarray(f), pairs),
            lambda p: regularizer.normal_consistency(p, torch.as_tensor(f), pairs), [v])
    edges = jmesh.unique_edges(f)
    _parity(lambda p: jreg.avg_edge_length(p, jnp.asarray(edges)),
            lambda p: regularizer.avg_edge_length(p, edges), [v])
    buf = rng.uniform(size=(10, 12, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (10, 12, 2), jnp.float64))
    _parity(lambda b: jreg.image_grad(b, key),
            lambda b: regularizer.image_grad(b, noise=torch.as_tensor(noise)), [buf])


def _render_scene(seed):
    """An icosphere (and a second, smaller one behind it) under an MLP
    texture and a light, from JAX's PRNGKey(seed)."""
    v, f = _icosphere(2, 0.5)
    v2 = v * 0.4 + np.array([0.2, 0.1, -0.6], np.float32)
    v_all = np.concatenate([v, v2])
    f_all = np.concatenate([f, f + len(v)]).astype(np.int32)
    aabb = (np.array([-1.0] * 3), np.array([1.0] * 3))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = JTex(aabb, hidden=16)
    jl = jlight.EnvironmentLight(16)
    jparams = {"tex": jt.init_params(k1), "light": jl.init_params(k2)}
    jparams["light"]["base"] = jparams["light"]["base"].astype(jnp.float32)
    tparams = joint_params_from_jax(jax.tree.map(np.asarray, jparams))
    campos = np.array([0.4, 0.3, 2.6], np.float32)
    from diffsound_tpu.experiments.joint import look_at_mvp

    mvp = look_at_mvp(campos).astype(np.float32)
    return v_all, f_all, jt, jl, jparams, tparams, campos, mvp


@pytest.mark.parametrize("layers,spp", [(2, 1), (1, 2)])
def test_render_mesh_peeling_and_supersampling(layers, spp):
    v, f, jt, jl, jparams, tparams, campos, mvp = _render_scene(1)
    aabb = (np.array([-1.0] * 3), np.array([1.0] * 3))
    tt, tl = MLPTexture3D(aabb, hidden=16), light.EnvironmentLight(16)
    jm = jmesh.auto_normals(jmesh.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f),
                                       material={"kd_ks_normal": jt, "bsdf": "pbr"}))
    tm = mesh.auto_normals(mesh.Mesh(v_pos=torch.as_tensor(v), t_pos_idx=torch.as_tensor(f),
                                     material={"kd_ks_normal": tt, "bsdf": "pbr"}))
    bg = np.random.default_rng(0).uniform(size=(24, 24, 3)).astype(np.float32)
    jo = jrender.render_mesh(jm, {"kd_ks_normal": jparams["tex"]}, jl, jparams["light"],
                             jnp.asarray(mvp), jnp.asarray(campos), (24, 24), num_layers=layers,
                             background=jnp.asarray(bg), spp=spp)
    to = render.render_mesh(tm, {"kd_ks_normal": tparams["tex"]}, tl, tparams["light"], mvp,
                            campos, (24, 24), num_layers=layers, background=torch.as_tensor(bg),
                            spp=spp)
    for k in ("shaded", "kd_grad", "occlusion"):
        a, b = to[k].numpy(), np.asarray(jo[k])
        assert a.shape[:2] == (24, 24) and a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * np.abs(b).max(), err_msg=k)
    assert 0.05 < float(np.asarray(jo["shaded"])[..., 3].mean()) < 0.95


def test_save_image_writes_rgb_png(tmp_path):
    img = np.random.default_rng(0).uniform(size=(5, 7, 3))
    util.save_image(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[25] == 2  # colour type RGB
    util.save_image(str(tmp_path / "a.npy"), img)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), img.astype(np.float32))
    write_png(str(tmp_path / "g.png"), np.zeros((3, 4), np.uint8))
    assert (tmp_path / "g.png").read_bytes()[25] == 0  # grayscale
