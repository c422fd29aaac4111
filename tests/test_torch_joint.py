"""The port's joint image + audio task (diffsound_torch.geometry.joint_task,
the joint CLI, dmtet's render-path helpers) and its image-only DLMesh path
against the JAX package's on the CPU, at narrow widths (grid 10, hidden 32,
light_res 8, 4 + 6 modes, 32^2, tri_bucket 512).

One joint step: from the JAX package's PRNGKey(0) init, pretrained by the
JAX package toward a sphere (300 steps) and converted
(`convert.joint_params_from_jax`), at JAX's compaction, padded surface and
host ARPACK basis and with JAX's jitter draw fed in as the noise tensor:
the loss and its three parts, and the gradient of every parameter group
(front, back, deform, tex, light) against `jax.value_and_grad(_loss_core)`,
the audio part in float64 and the render in float32 in both packages.  The
JAX side runs once (a module fixture), so its jit compiles once; JAX's
`optimize` never runs here.  Then the port alone: its own step, `optimize`,
the CLI at grid 8, DLMesh."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.experiments import joint as jjoint
from diffsound_tpu.geometry import dlmesh as jdlmesh
from diffsound_tpu.geometry.dmtet import MarchingTets as JMT
from diffsound_tpu.geometry.dmtet import map_uv as j_map_uv
from diffsound_tpu.geometry.dmtet import sdf_reg_loss as j_sdf_reg_loss
from diffsound_tpu.geometry.joint_task import JointImageAudioTask as JTask
from diffsound_tpu.geometry.joint_task import masked_auto_normals as j_normals
from diffsound_tpu.render import light as jlight
from diffsound_tpu.render import mesh as jmesh
from diffsound_tpu.render.mlptexture import MLPTexture3D as JTex

from diffsound_torch.convert import joint_params_from_jax
from diffsound_torch.experiments import joint
from diffsound_torch.fem.mesh import icosphere
from diffsound_torch.geometry.dlmesh import DLMesh
from diffsound_torch.geometry.dmtet import MarchingTets, map_uv, sdf_reg_loss
from diffsound_torch.geometry.joint_task import JointImageAudioTask, masked_auto_normals
from diffsound_torch.render import mesh as rmesh
from diffsound_torch.render.light import EnvironmentLight
from diffsound_torch.render.mlptexture import MLPTexture3D
from diffsound_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

GRID, MODES, HIDDEN, LIGHT, RES, BUCKET = 10, 4, 32, 8, (32, 32), 512
TARGET_VALS = np.array([1.5e7, 2.0e7, 2.6e7, 3.1e7])
GROUPS = ("front", "back", "deform", "tex", "light")


def _group(tree, name):
    """One parameter group's leaves as one float64 vector."""
    sub = tree["geo"][name] if name in ("front", "back", "deform") else tree[name]
    return torch.cat([x.reshape(-1).double() for x in tree_leaves(sub)])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's task, params (PRNGKey(0), light in float32, both
    nets pretrained 300 steps toward a 0.35 ball), the march and its
    compactions, the host basis, a view and one value_and_grad of
    `_loss_core` in float64 (the render in float32)."""
    j = JTask(grid_res=GRID, mode_num=MODES, light_res=LIGHT, hidden_dim=HIDDEN,
              tets_dir="/nonexistent", dtype=jnp.float64)
    p = dict(j.init_params(jax.random.PRNGKey(0)))
    p["light"] = {"base": p["light"]["base"].astype(jnp.float32)}
    pts = j.grid_verts
    p["geo"] = j.geo.pretrain_regression(p["geo"], pts, 0.35 - np.linalg.norm(pts, axis=-1),
                                         iters=300, lr=3e-4)
    out = j._march_host(p)
    comp = JMT.compact(out)
    tric = JMT.compact_triangles_padded(out, BUCKET)
    v_tex, t_tex_idx = j_map_uv(tric["face_gidx"], out.surf_tris.shape[0])
    lam, U = j._eigensolve_host(out, comp, MODES + 6)
    campos = np.array([0.4, 0.5, 2.7])
    mvp = jjoint.look_at_mvp(campos)
    img = np.zeros(RES + (4,), np.float32)
    img[9:23, 7:25] = (0.6, 0.5, 0.4, 1.0)
    key = jax.random.PRNGKey(1)
    view = dict(img=img, mvp=mvp, campos=campos, t_iter=0.1, audio_weight=0.5, sdf_reg=0.02)
    (loss, aux), g = jax.jit(jax.value_and_grad(j._loss_core, has_aux=True),
                             static_argnames=("resolution",))(
        p, jnp.asarray(comp["keep_idx"]), jnp.asarray(comp["tets"]),
        jnp.asarray(comp["tet_mask"], jnp.float64), jnp.asarray(tric["tris"]),
        jnp.asarray(tric["tri_mask"]), jnp.asarray(v_tex), jnp.asarray(t_tex_idx),
        jnp.asarray(lam), jnp.asarray(U), jnp.asarray(TARGET_VALS), jnp.asarray(img),
        jnp.asarray(mvp, jnp.float32), jnp.asarray(campos, jnp.float32), jnp.float32(0.1), key,
        jnp.float32(0.5), jnp.float32(0.02), resolution=RES)
    return dict(task=j, params=p, out=out, comp=comp, tric=tric, v_tex=v_tex,
                t_tex_idx=t_tex_idx, lam=lam, U=U, view=view,
                noise=np.array(jax.random.normal(key, RES + (3,), jnp.float32)),
                loss=float(loss), aux=[float(a) for a in aux],
                grads=joint_params_from_jax(jax.tree.map(np.asarray, g)))


@pytest.fixture(scope="module")
def port_task():
    return JointImageAudioTask(grid_res=GRID, mode_num=MODES, light_res=LIGHT, hidden_dim=HIDDEN,
                               tets_dir="/nonexistent", dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def port_params(jax_side):
    return joint_params_from_jax(jax.tree.map(np.asarray, jax_side["params"]))


def test_map_uv_equals_jax():
    rng = np.random.default_rng(0)
    for total in (7, 1000, 165888):
        gidx = np.sort(rng.choice(total, size=min(total, 300), replace=False))
        for a, b in zip(map_uv(gidx, total), j_map_uv(gidx, total)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_march_and_compactions_equal_jax(jax_side, port_task, port_params):
    """The float64 march (the MLPs' products round in another order: the
    vertices to 1e-14) and its compactions, exactly."""
    out = port_task._march_host(port_params)
    jo = jax_side["out"]
    np.testing.assert_allclose(out.all_verts.numpy(), np.asarray(jo.all_verts), rtol=0, atol=1e-14)
    np.testing.assert_array_equal(out.tri_mask.numpy(), np.asarray(jo.tri_mask))
    for k, v in MarchingTets.compact_triangles_padded(out, BUCKET).items():
        np.testing.assert_array_equal(v, jax_side["tric"][k], err_msg=k)
    for k, v in MarchingTets.compact(out).items():
        np.testing.assert_array_equal(v, jax_side["comp"][k], err_msg=k)
    assert jax_side["tric"]["num_tris"] > 100 and len(jax_side["tric"]["tris"]) % BUCKET == 0


def test_sdf_reg_loss_and_its_gradient():
    rng = np.random.default_rng(1)
    sdf = rng.normal(size=200) * 0.1
    sdf[:5] = 0.0  # sign 0 on both sides of a few edges
    edges = rng.integers(0, 200, size=(600, 2))
    want = j_sdf_reg_loss(jnp.asarray(sdf), jnp.asarray(edges))
    gj = np.asarray(jax.grad(lambda s: j_sdf_reg_loss(s, jnp.asarray(edges)))(jnp.asarray(sdf)))
    s = torch.tensor(sdf, requires_grad=True)
    got = sdf_reg_loss(s, torch.as_tensor(edges))
    (gt,) = torch.autograd.grad(got, s)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-13)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-13 * np.abs(gj).max())
    # no crossing edge: 0 over a denominator of 1
    assert sdf_reg_loss(torch.ones(3, dtype=torch.float64), torch.tensor([[0, 1]])).item() == 0.0


def test_masked_auto_normals_and_the_cards_gather_sum():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(12, 3))
    tris = np.array([[0, 1, 2], [2, 3, 4], [0, 2, 4], [5, 6, 7], [0, 0, 0], [0, 0, 0]])
    mask = np.array([1, 1, 1, 1, 0, 0], np.float64)
    jn, jf = j_normals(jnp.asarray(v), jnp.asarray(tris), jnp.asarray(mask))
    vt = torch.tensor(v, requires_grad=True)
    tn, tf = masked_auto_normals(vt, torch.as_tensor(tris), torch.as_tensor(mask))
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), atol=1e-14)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), atol=1e-14)
    w = rng.normal(size=(12, 3))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(
        j_normals(x, jnp.asarray(tris), jnp.asarray(mask))[0] * w))(jnp.asarray(v)))
    (gt,) = torch.autograd.grad((tn * torch.as_tensor(w)).sum(), vt)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-12 * np.abs(gj).max())
    # the card's transpose is built from the real triangles only: vertex 0's
    # padding does not set its depth, and its sums equal index_add_'s
    gidx = rmesh.gather_index(tris, 12, num_real=4)
    assert gidx.shape[1] == 3 and int(gidx.max()) == 3 * len(tris)
    rows = torch.randn(3 * len(tris), 3, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0)) * torch.as_tensor(
        np.repeat(mask, 3))[:, None]
    padded = torch.cat([rows, rows.new_zeros(1, 3)])
    torch.testing.assert_close(padded[gidx].sum(1),
                               rmesh.vertex_sum(rows, torch.as_tensor(tris), 12),
                               rtol=0, atol=1e-15)


def test_joint_step_matches_jax(jax_side, port_task, port_params):
    """The loss to 1e-9 relative, its image and regularizer parts to 1e-6
    (float32 renders), the audio part to 1e-9; each group's gradient in
    relative norm: the geometry's to 1e-6, the texture's and the light's
    (float32 only) to 1e-4."""
    s, v = jax_side, jax_side["view"]
    loss, aux, g = port_task.loss_grad(
        port_params, s["comp"], s["tric"], s["v_tex"], s["t_tex_idx"], s["lam"], s["U"],
        TARGET_VALS, v["img"], v["mvp"], v["campos"], v["t_iter"], torch.as_tensor(s["noise"]),
        v["audio_weight"], v["sdf_reg"], RES)
    np.testing.assert_allclose(loss.item(), s["loss"], rtol=1e-9)
    for got, want, rtol in zip(aux, s["aux"], (1e-6, 1e-6, 1e-9)):
        np.testing.assert_allclose(got.item(), want, rtol=rtol)
    assert 0 < s["aux"][0] and 0 < s["aux"][2]
    for name, tol in zip(GROUPS, (1e-6, 1e-6, 1e-6, 1e-4, 1e-4)):
        a, b = _group(g, name), _group(s["grads"], name)
        assert torch.isfinite(a).all() and b.norm() > 0, name
        assert float((a - b).norm() / b.norm()) <= tol, name


def test_convert_joint_init_renders_as_jax(jax_side, port_task, port_params):
    """JAX's init converted gives JAX's target renders of the two-sphere
    ground truth (the CLI's render_target_views) to 1e-5."""
    j = jax_side["task"]
    sd = jjoint.gt_sdf_two_spheres(j.grid_verts)
    jout = j.marching(jax.device_put(j.grid_verts, jax.devices("cpu")[0]), jnp.asarray(sd))
    out = port_task.marching(torch.as_tensor(port_task.grid_verts), torch.as_tensor(sd))
    cams = jjoint.ring_cameras(2, 2.7)
    want = jjoint.render_target_views(j, jax_side["params"], jout, cams, RES)
    got = joint.render_target_views(port_task, port_params, out, joint.ring_cameras(2, 2.7), RES)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["mvp"], b["mvp"], rtol=1e-15)
        assert a["img"].dtype == np.float32 and 0.03 < b["img"][..., 3].mean() < 0.9
        np.testing.assert_allclose(a["img"], b["img"], rtol=0, atol=1e-5)


def test_own_step_matches_jax_loss(jax_side, port_task, port_params):
    """The port's step_loss_grad (its own march, compactions and first,
    cold, warm-solver solve) reads JAX's loss: the corrected eigenvalues of
    two ARPACK bases agree to solver accuracy."""
    v = jax_side["view"]
    loss, aux, g, comp, out, timing = port_task.step_loss_grad(
        port_params, TARGET_VALS, v["img"], v["mvp"], v["campos"], v["t_iter"],
        torch.as_tensor(jax_side["noise"]), v["audio_weight"], v["sdf_reg"], resolution=RES,
        tri_bucket=BUCKET)
    np.testing.assert_allclose(loss.item(), jax_side["loss"], rtol=1e-8)
    assert timing["solve_mode"] == "cold" and set(tree_leaves(g)) and all(
        torch.isfinite(x).all() for x in tree_leaves(g))


def test_optimize_three_iterations(port_params):
    task = JointImageAudioTask(grid_res=GRID, mode_num=MODES, light_res=LIGHT, hidden_dim=HIDDEN,
                               tets_dir="/nonexistent", dtype=torch.float64, device="cpu")
    campos = np.array([0.0, 0.0, 3.0])
    targets = [{"img": np.zeros(RES + (4,), np.float32), "mvp": joint.look_at_mvp(campos),
                "campos": campos}]
    params, best, hist = task.optimize(port_params, TARGET_VALS, targets, iters=3,
                                       resolution=RES, verbose=False, audio_weight=1e-6)
    assert len(hist) == 3 and all("skipped" not in r for r in hist)
    assert np.isfinite([r["loss"] for r in hist]).all() and np.isfinite(best["loss"])
    assert best["verts"].shape[1] == 3 and best["tets"].shape[1] == 4
    assert task.warm.total_cold == 1 and task.warm.total_warm == 2
    moved = (params["geo"]["deform"] - port_params["geo"]["deform"]).abs().max().item()
    assert moved > 0 and params["tex"]["layers.0.weight"].dtype == torch.float32


def test_optimize_records_a_step_that_raises(port_params, monkeypatch):
    task = JointImageAudioTask(grid_res=GRID, mode_num=MODES, light_res=LIGHT, hidden_dim=HIDDEN,
                               tets_dir="/nonexistent", dtype=torch.float64, device="cpu")
    calls = []
    step = task.step_loss_grad

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("degenerate mesh")
        return step(*a, **k)

    monkeypatch.setattr(task, "step_loss_grad", flaky)
    campos = np.array([0.0, 0.0, 3.0])
    targets = [{"img": np.zeros(RES + (4,), np.float32), "mvp": joint.look_at_mvp(campos),
                "campos": campos}]
    _, _, hist = task.optimize(port_params, TARGET_VALS, targets, iters=2, resolution=RES,
                               verbose=False)
    assert hist[0] == {"iter": 0, "skipped": "ValueError: degenerate mesh"}
    assert hist[1]["iter"] == 1 and np.isfinite(hist[1]["loss"])


def test_joint_cli_on_the_cpu(tmp_path):
    out_dir = tmp_path / "joint"
    summary = joint.main(["--config", "configs/joint_train.json", "--device", "cpu",
                          "--grid_res", "8", "--resolution", "16", "--n_views", "2",
                          "--mode_num", "4", "--hidden_dim", "16", "--light_res", "8",
                          "--out_dir", str(out_dir), "--iter", "2"])
    files = set(os.listdir(out_dir))
    assert {"result.txt", "render_target.png", "render_initial.png", "render_final.png",
            "best_mesh.obj", "metrics.jsonl"} <= files
    line = json.loads((out_dir / "result.txt").read_text().splitlines()[-1])
    assert line == summary and line["iters"] == 2 and np.isfinite(line["best_loss"])
    assert line["cold_solves"] + line["warm_solves"] == 2


def _dlmesh_pair(res_light=8):
    """The JAX package's DLMesh and the port's on an icosphere of radius 0.5,
    the texture and light from JAX's PRNGKey(0), no jitter."""
    v, f = icosphere(1, 0.5)
    v, f = v.astype(np.float32), f.astype(np.int32)
    aabb = (np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]))
    jt, jl = JTex(aabb), jlight.EnvironmentLight(base_res=res_light)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp = {"tex": jt.init_params(k1), "light": jl.init_params(k2)}
    jp["light"]["base"] = jp["light"]["base"].astype(jnp.float32)
    tp = joint_params_from_jax(jax.tree.map(np.asarray, jp))
    jgeo = jdlmesh.DLMesh(jmesh.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f)), jl,
                          {"kd_ks_normal": jt, "bsdf": "pbr"}, laplace_scale=100.0,
                          total_iters=40)
    tgeo = DLMesh(rmesh.Mesh(v_pos=torch.as_tensor(v), t_pos_idx=torch.as_tensor(f)),
                  EnvironmentLight(base_res=res_light),
                  {"kd_ks_normal": MLPTexture3D(aabb), "bsdf": "pbr"}, laplace_scale=100.0,
                  total_iters=40, device="cpu")
    jparams = {"v_pos": jgeo.initial_v_pos, **jp}
    return jgeo, tgeo, jparams, tgeo.init_params(tp["tex"], tp["light"])


def test_dlmesh_tick_matches_jax():
    """tick's image and regularizer losses and the vertices' gradient,
    without jitter, against the JAX package's (float32 renders: 1e-5 and
    1e-4 relative)."""
    jgeo, tgeo, jparams, tparams = _dlmesh_pair()
    campos = np.array([0.3, 0.2, 2.5], np.float32)
    mvp = joint.look_at_mvp(campos).astype(np.float32)
    img = np.zeros(RES + (4,), np.float32)
    img[10:22, 10:22] = (0.5, 0.4, 0.3, 1.0)
    rng_v = np.random.default_rng(3).normal(size=jparams["v_pos"].shape).astype(np.float32)
    jparams["v_pos"] = jparams["v_pos"] + 0.01 * rng_v
    tparams["v_pos"] = tparams["v_pos"] + 0.01 * torch.as_tensor(rng_v)

    def jtotal(vp):
        il, rl = jgeo.tick({**jparams, "v_pos": vp}, jnp.asarray(img), jnp.asarray(mvp),
                           jnp.asarray(campos), 30.0, None, RES)
        return il + rl, (il, rl)

    (_, (jil, jrl)), gj = jax.value_and_grad(jtotal, has_aux=True)(jparams["v_pos"])
    vp = tparams["v_pos"].clone().requires_grad_(True)
    il, rl = tgeo.tick({**tparams, "v_pos": vp}, torch.as_tensor(img), mvp, campos, 30.0, RES)
    (gt,) = torch.autograd.grad(il + rl, vp)
    np.testing.assert_allclose(il.item(), float(jil), rtol=1e-5)
    np.testing.assert_allclose(rl.item(), float(jrl), rtol=1e-5)
    gj = np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def test_dlmesh_shrinks_to_the_silhouette():
    """As the JAX package's test: a descent step along d(alpha MSE)/d(v_pos)
    shrinks the rendered coverage, and the loop moves the vertices."""
    _, geo, _, params = _dlmesh_pair()
    campos = np.array([0.0, 0.0, 2.5])
    targets = [{"img": np.zeros(RES + (4,), np.float32), "mvp": joint.look_at_mvp(campos),
                "campos": campos}]

    def coverage(v_pos):
        buf = geo.render({**params, "v_pos": v_pos}, targets[0]["mvp"], campos, RES)
        return buf["shaded"][..., 3]

    vp = params["v_pos"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad((coverage(vp) ** 2).mean(), vp)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    step = 0.05 / g.abs().max()
    with torch.no_grad():
        assert coverage(params["v_pos"] - step * g).sum() < coverage(params["v_pos"]).sum()
    out, hist = geo.optimize(params, targets, iters=10, lr=1e-2, resolution=RES, verbose=False)
    assert np.isfinite(hist[-1]["loss"]) and hist[-1]["img"] < hist[0]["img"]
    assert (out["v_pos"] - geo.initial_v_pos).abs().max() > 1e-4
    spp = geo.render(out, targets[0]["mvp"], campos, RES, spp=2)
    assert all(torch.isfinite(x).all() for x in spp.values())


def test_a_host_anchor_with_its_guard_columns(port_task, port_params):
    """A host anchor solves for the warm solver's guard columns too (every
    task's does): the solver asks for k + guards modes, stores them all and
    hands back the first k; the joint task's rounds are WARM_MAX_ITERS."""
    from diffsound_torch.geometry.warm_eigs import WarmShapeEigensolver

    out = port_task._march_host(port_params)
    comp = MarchingTets.compact(out)
    assert port_task.warm.max_iters == port_task.WARM_MAX_ITERS
    w = WarmShapeEigensolver(port_task.warm.num_global_slots, MODES + 6,
                             dtype=torch.float64, device="cpu")
    mu, lam = port_task._lame()
    asked = []
    vals, U = w.solve(out, comp, float(mu), float(lam), host_solve=lambda n: (
        asked.append(n), port_task._eigensolve_host(out, comp, n))[1])
    assert asked == [w.kg] and w.last_mode == "cold" and len(vals) == w.k and U.shape[1] == w.k
    keep = torch.as_tensor(comp["keep_idx"][: comp["num_verts"]])
    stored = w.U_global[keep].reshape(-1, w.kg)
    assert (torch.linalg.vector_norm(stored, dim=0) > 0).all()
    np.testing.assert_allclose(stored[:, : w.k].double().numpy(),
                               U[: 3 * comp["num_verts"]], rtol=0, atol=1e-6)
