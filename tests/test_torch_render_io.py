"""The rest of the port's render package against the JAX package's, on
tests/test_render.py's cases: mip chains and Texture2D sampling (with and
without mips, values and gradients), materials and OBJ/MTL IO both ways
between the packages, the latlong and cubemap conversions and
EnvironmentLight.from_latlong, the camera helpers, the sRGB transfer,
image pooling and resizing, render_uv and a textured render_mesh, and
load_image of what save_image writes (and of PNGs that imageio writes)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.render import light as jlight
from diffsound_tpu.render import material as jmaterial
from diffsound_tpu.render import mesh as jmesh
from diffsound_tpu.render import obj as jobj
from diffsound_tpu.render import render as jrender
from diffsound_tpu.render import texture as jtexture
from diffsound_tpu.render import util as jutil
from diffsound_tpu.render.mlptexture import MLPTexture3D as JMLP

from diffsound_torch.convert import joint_params_from_jax
from diffsound_torch.render import light, material, obj, render, texture, util
from diffsound_torch.render.mesh import Mesh, auto_normals, compute_tangents
from diffsound_torch.render.mlptexture import MLPTexture3D

torch.set_num_threads(2)

T = lambda a: torch.as_tensor(np.array(a))


def _close(a, b, tol=1e-6):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


# -- textures ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 3), (13, 10, 4)])
def test_mip_chain_matches_jax(shape):
    img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    tm, jm = texture.mip_chain(T(img)), jtexture.mip_chain(jnp.asarray(img))
    assert len(tm) == len(jm)
    for a, b in zip(tm, jm):
        _close(a, b)
    assert len(texture.mip_chain(T(img), max_mips=2)) == 2


@pytest.mark.parametrize("mode", ["derivatives", "bias", "one_mip", "mip_list"])
def test_texture2d_sample_value_and_grad_match_jax(mode):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    uv = rng.uniform(size=(5, 7, 2)).astype(np.float32)
    deriv = (rng.uniform(size=(5, 7, 4)) * 0.3).astype(np.float32)
    bias = rng.uniform(0, 3, size=(5, 7)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode == "derivatives":
        kw_j, kw_t = {"uv_deriv": jnp.asarray(deriv)}, {"uv_deriv": T(deriv)}
    elif mode == "bias":
        kw_j, kw_t = {"mip_bias": jnp.asarray(bias)}, {"mip_bias": T(bias)}
    init = [img, img[::2, ::2]] if mode == "mip_list" else img
    jt = jtexture.Texture2D(init, auto_mips=mode != "one_mip")
    tt = texture.Texture2D(init, auto_mips=mode != "one_mip")
    w = rng.standard_normal((5, 7, 3)).astype(np.float32)

    def jf(p):
        return jnp.sum(jt.sample(p, jnp.asarray(uv), **kw_j) * w)

    vj, gj = jax.value_and_grad(jf)(jt.params)
    p = ([m.clone().requires_grad_(True) for m in tt.params] if mode == "mip_list"
         else tt.params.clone().requires_grad_(True))
    vt = (tt.sample(p, T(uv), **kw_t) * T(w)).sum()
    gt = torch.autograd.grad(vt, p)
    _close(vt, vj, 1e-5)
    for a, b in zip(gt, gj if mode == "mip_list" else [gj]):
        _close(a, b, 1e-5)


def test_constant_texture_levels_and_clamp():
    tex = texture.Texture2D(np.asarray([0.2, 0.4, 0.6], np.float32), min_max=[[0, 0.3, 0],
                                                                              [1, 1, 0.5]])
    _close(tex.sample(tex.params, T([[0.3, 0.9]]))[0], [0.2, 0.4, 0.6])
    _close(tex.clamp(tex.params)[0, 0], [0.2, 0.4, 0.5])
    half = texture.Texture2D(np.ones((16, 16, 3), np.float32) * 0.5)
    _close(half.sample(half.params, T([[0.5, 0.5]]), mip_bias=T([3.0])), 0.5)
    img = np.random.default_rng(2).uniform(-1, 2, size=(8, 8, 3)).astype(np.float32)
    jt = jtexture.Texture2D(img, min_max=[[0, 0, 0], [1, 1, 1]])
    tt = texture.Texture2D(img, min_max=[[0, 0, 0], [1, 1, 1]])
    _close(tt.clamp(tt.params), jt.clamp(jt.params))
    _close(texture.srgb_texture(img.clip(0, 1)), jtexture.srgb_texture(img.clip(0, 1)))


# -- util -------------------------------------------------------------------


def test_srgb_tonemap_pool_and_resize_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.5, size=(2, 8, 12, 3)).astype(np.float32)
    for tf, jf in ((util.srgb_to_rgb, jutil.srgb_to_rgb), (util.rgb_to_srgb, jutil.rgb_to_srgb),
                   (util.tonemap_srgb, jutil.tonemap_srgb)):
        _close(tf(T(x).clamp(min=0) if tf is not util.tonemap_srgb else T(x)),
               jf(jnp.asarray(x.clip(0) if tf is not util.tonemap_srgb else x)), 1e-6)
    _close(util.avg_pool_nhwc(T(x), 2), jutil.avg_pool_nhwc(jnp.asarray(x), 2))
    for size, method in (((16, 24), "nearest"), ((4, 5), "nearest"), ((16, 20), "bilinear"),
                         ((4, 6), "bilinear")):
        _close(util.scale_img_nhwc(T(x), size, method),
               jutil.scale_img_nhwc(jnp.asarray(x), size, method), 1e-5)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    m = rng.standard_normal((4, 4)).astype(np.float32)
    _close(util.xfm_vectors(T(v), T(m)), jutil.xfm_vectors(jnp.asarray(v), jnp.asarray(m)))


def test_camera_helpers_match_jax():
    for fn, args in ((util.perspective, (0.9, 1.3, 0.2, 50.0)), (util.translate, (1, -2, 3)),
                     (util.rotate_x, (0.7,)), (util.rotate_y, (-1.2,)),
                     (util.lookat, ([0.3, 1, 2.5], [0, 0.1, 0], [0, 1, 0]))):
        np.testing.assert_array_equal(fn(*args), getattr(jutil, fn.__name__)(*args))
    for seed in range(3):
        a = util.random_camera(np.random.default_rng(seed), radius=2.5)
        b = jutil.random_camera(np.random.default_rng(seed), radius=2.5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    g = np.linspace(-1, 1, 5).astype(np.float32)
    for face in range(6):
        _close(util.cube_to_dir(face, T(g), T(g[::-1])),
               jutil.cube_to_dir(face, jnp.asarray(g), jnp.asarray(g[::-1])))


def test_latlong_cubemap_both_ways_and_from_latlong_match_jax():
    rng = np.random.default_rng(4)
    ll = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    cube = util.latlong_to_cubemap(T(ll), 8)
    _close(cube, jutil.latlong_to_cubemap(jnp.asarray(ll), 8), 1e-5)
    cm = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    _close(util.cubemap_to_latlong(T(cm), (10, 20)),
           jutil.cubemap_to_latlong(jnp.asarray(cm), (10, 20)), 1e-5)
    tl, tp = light.EnvironmentLight.from_latlong(ll, base_res=16)
    jl, jp = jlight.EnvironmentLight.from_latlong(ll, base_res=16)
    assert tl.base_res == jl.base_res == 16 and tl.n_mips == jl.n_mips
    _close(tp["base"], jp["base"], 1e-5)
    # a constant map stays constant through both conversions
    flat = util.cubemap_to_latlong(util.latlong_to_cubemap(torch.full((8, 16, 3), 0.25), 8),
                                   (8, 16))
    _close(flat, 0.25)


@pytest.mark.parametrize("kind", ["rgb", "gray", "npy"])
def test_load_image_reads_what_save_image_wrote(tmp_path, kind):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(9, 7, 3) if kind != "gray" else (9, 7)).astype(np.float32)
    path = str(tmp_path / f"img.{'npy' if kind == 'npy' else 'png'}")
    util.save_image(path, img)
    back = util.load_image(path)
    assert back.dtype == np.float32 and back.shape == img.shape
    tol = 0 if kind == "npy" else 1.0 / 255
    np.testing.assert_allclose(back, img, atol=tol)
    np.testing.assert_allclose(back, jutil.load_image(path), atol=1e-7)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_load_image_reads_imageio_pngs(tmp_path, channels):
    """PNGs from another encoder (imageio picks row filters per row), in the
    four 8-bit colour types."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[:23, :31]
    smooth = ((np.sin(xx / 4.0 + channels)[..., None] * np.cos(yy / 5.0)[..., None] + 1) * 120
              + rng.integers(0, 12, (23, 31, channels))).astype(np.uint8)
    arr = smooth[..., 0] if channels == 1 else smooth
    path = str(tmp_path / "io.png")
    imageio.imwrite(path, arr)
    np.testing.assert_array_equal(util.load_image(path) * 255.0, arr.astype(np.float32))


# -- materials and OBJ ----------------------------------------------------------


def _quad():
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def _port_mesh(mat):
    verts, tris = _quad()
    uv = verts[:, :2] + 0.5
    m = Mesh(v_pos=T(verts), t_pos_idx=T(tris), v_tex=T(uv), t_tex_idx=T(tris), material=mat)
    return compute_tangents(auto_normals(m))


def _jax_mesh(mat):
    verts, tris = _quad()
    m = jmesh.Mesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(tris.astype(np.int32)),
                   v_tex=jnp.asarray(verts[:, :2] + 0.5),
                   t_tex_idx=jnp.asarray(tris.astype(np.int32)), material=mat)
    return jmesh.compute_tangents(jmesh.auto_normals(m))


def test_default_material_and_params_match_jax():
    tm, jm = material.default_material(), jmaterial.default_material()
    assert tm.keys() == jm.keys() and tm["bsdf"] == jm["bsdf"]
    tp, jp = material.material_params(tm), jmaterial.material_params(jm)
    assert tp.keys() == jp.keys()
    for k in tp:
        _close(tp[k], jp[k])
        assert tm[k].min_max == jm[k].min_max
    merged = material.merge_materials([tm, jm], "tc", "tf", "mf")
    assert merged == (tm, "tc", "tf")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_obj_and_mtl_round_trip_between_the_packages(tmp_path, writer):
    """One package writes the mesh (and an image-textured kd), the port and
    the JAX package read it back alike."""
    kd = np.random.default_rng(7).uniform(size=(4, 4, 3)).astype(np.float32)
    if writer == "port":
        mat = material.default_material()
        mat["kd"] = texture.Texture2D(kd)
        obj.write_obj(str(tmp_path), _port_mesh(mat))
    else:
        mat = jmaterial.default_material()
        mat["kd"] = jtexture.Texture2D(kd)
        jobj.write_obj(str(tmp_path), _jax_mesh(mat))
    tm = obj.load_obj(str(tmp_path / "mesh.obj"), device="cpu")
    jm = jobj.load_obj(str(tmp_path / "mesh.obj"))
    verts, tris = _quad()
    _close(tm.v_pos, verts, 1e-5)
    np.testing.assert_array_equal(tm.t_pos_idx.numpy(), tris)
    for f in ("v_pos", "v_tex", "v_nrm", "v_tng"):
        _close(getattr(tm, f), getattr(jm, f), 1e-5)
    for f in ("t_pos_idx", "t_tex_idx", "t_nrm_idx"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    # map_Kd went out through the sRGB transfer and came back to linear
    _close(tm.material["kd"].params, jm.material["kd"].params, 1e-6)
    _close(tm.material["kd"].params, kd, 2.5e-2)
    _close(tm.material["ks"].params, jm.material["ks"].params)


def test_load_obj_fans_polygons_and_derives_normals(tmp_path):
    (tmp_path / "p.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    tm = obj.load_obj(str(tmp_path / "p.obj"), device="cpu")
    jm = jobj.load_obj(str(tmp_path / "p.obj"))
    np.testing.assert_array_equal(tm.t_pos_idx.numpy(), [[0, 1, 2], [0, 2, 3]])
    _close(tm.v_nrm, jm.v_nrm, 1e-6)
    assert tm.v_tex is None and tm.material["name"] == "_default_mat"


# -- render_uv and a textured render -------------------------------------------


def test_render_uv_bake_matches_jax():
    aabb = (np.full(3, -1.0), np.full(3, 1.0))
    jt, tt = JMLP(aabb, hidden=16), MLPTexture3D(aabb, hidden=16)
    jp = jt.init_params(jax.random.PRNGKey(0))
    tp = joint_params_from_jax({"tex": jax.tree.map(np.asarray, jp)})["tex"]
    jmask, jkd, jks, jn = jrender.render_uv(_jax_mesh(None), (32, 32), jt, jp)
    tmask, tkd, tks, tn = render.render_uv(_port_mesh(None), (32, 32), tt, tp)
    assert tmask.shape == (32, 32, 1) and float(tmask.sum()) > 0
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for a, b in ((tkd, jkd), (tks, jks), (tn, jn)):
        _close(a, b, 1e-5)


def test_textured_render_mesh_matches_jax():
    """tests/test_render.py's scene with the default material's Texture2D
    kd and ks, rendered by both packages."""
    jm, tm = jmaterial.default_material(), material.default_material()
    jl, tl = jlight.EnvironmentLight(base_res=16), light.EnvironmentLight(base_res=16)
    mvp = util.perspective(0.7854) @ util.lookat([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
    jout = jrender.render_mesh(_jax_mesh(jm), jmaterial.material_params(jm), jl,
                               {"base": jnp.ones((6, 16, 16, 3)) * 0.8}, mvp, [0, 0, 2.5],
                               (32, 32))
    tout = render.render_mesh(_port_mesh(tm), material.material_params(tm), tl,
                              {"base": torch.ones((6, 16, 16, 3)) * 0.8}, mvp, [0, 0, 2.5],
                              (32, 32))
    img = tout["shaded"]
    assert img.shape == (32, 32, 4) and float(img[16, 16, 3]) > 0.9
    _close(img, jout["shaded"], 2e-5)


def _filtered_png(path, img):
    """An RGB PNG whose row r uses filter r % 5 (None, Sub, Up, Average,
    Paeth), encoded here by the PNG specification's definitions."""
    import struct
    import zlib

    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for r in range(h):
        line = img[r].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        kind = r % 5
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prev = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_load_image_undoes_every_row_filter(tmp_path):
    img = np.random.default_rng(8).integers(0, 256, (11, 6, 3)).astype(np.uint8)
    path = str(tmp_path / "filters.png")
    _filtered_png(path, img)
    np.testing.assert_array_equal(util.load_image(path) * 255.0, img.astype(np.float32))
    np.testing.assert_array_equal(jutil.load_image(path) * 255.0, img.astype(np.float32))
