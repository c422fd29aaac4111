"""The port's geometry task (diffsound_torch.geometry.geometry_task and the
geometry CLI) against the JAX package's on the CPU in float64, at narrow
widths (grid 10, hidden 32, freq_num 1, 6 modes; the JAX side's SDF MLP is
swapped for a narrow one in the test): the march and compaction of the same
params, the loss and its gradient in every MLP parameter and in `deform`
against `jax.value_and_grad(GeometryTask._loss_core)` at the same
compaction and host basis (bucket padding included, rtol 1e-10) and through
each package's own `step_loss_grad` (rtol 1e-8: two ARPACK bases of one
span); a host-path `optimize` trajectory (rtol 1e-7; optax's float32
learning rate is 2e-8 off); the warm solver's `reanchor_every` cadence and
`map_only` steps (`refresh_every` 2) against the JAX package's mapped step
(rtol 1e-6, the stored basis is float32); a warm result above the
solver's acceptance bound replaced by host ARPACK's; and three behaviours
of the JAX package not carried over: a mapped step leaves a stale LOBPCG
count, each step forces two device syncs, and the CLI's best-mesh export
throttle, seeded at 0, can hold back the first improvement."""

import json
import os

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.geometry.dmtet import MarchingTets as JMT
from diffsound_tpu.geometry.geometry_task import GeometryTask as JTask
from diffsound_tpu.geometry.sdf_host import mesh_signed_distance as j_signed_distance
from diffsound_tpu.geometry.sdf_mlp import SDFGeometry as JGeo
from diffsound_tpu.geometry.sdf_mlp import voxel_boundary_faces as j_voxel_faces

from diffsound_torch.convert import sdf_params_from_jax
from diffsound_torch.experiments import geometry as geometry_cli
from diffsound_torch.fem.mesh import TetMesh, read_obj, write_obj
from diffsound_torch.geometry import geometry_task as gt_mod
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.geometry_task import GeometryTask
from diffsound_torch.geometry.sdf_mlp import SDFGeometry

torch.set_num_threads(2)

GRID, MODES, HIDDEN = 10, 6, 32


def _narrow(task, jax_side):
    geo = JGeo if jax_side else (lambda *a, **k: SDFGeometry(*a, **k, device="cpu"))
    task.geo = geo(task.grid_verts, GRID, 1.0, 1, hidden_dim=HIDDEN)
    return task


def _tasks(**kw):
    j = _narrow(JTask(grid_res=GRID, mode_num=MODES, tets_dir="/nonexistent", **kw), True)
    t = _narrow(GeometryTask(grid_res=GRID, mode_num=MODES, tets_dir="/nonexistent",
                             device="cpu", **kw), False)
    return j, t


def _to_port(jp):
    n = jax.tree.map(np.asarray, jp)
    return sdf_params_from_jax(n["mlp"], n["deform"])


def _shift(jp, ds):
    """The params with the output bias moved by ds (a remesh)."""
    out = jax.tree.map(lambda a: a, jp)
    out["mlp"]["params"]["Dense_4"]["bias"] = jp["mlp"]["params"]["Dense_4"]["bias"] + ds
    return out


def _grads_close(g_t, g_j, rtol):
    dense = g_j["mlp"]["params"]
    for i in range(len(dense)):
        for name, jv in (("weight", np.asarray(dense[f"Dense_{i}"]["kernel"]).T),
                         ("bias", np.asarray(dense[f"Dense_{i}"]["bias"]))):
            tv = g_t["mlp"][f"layers.{i}.{name}"].numpy()
            assert np.isfinite(tv).all()
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=rtol * np.abs(jv).max(),
                                       err_msg=f"layer {i} {name}")
    # deform's gradient sums over the edges of each grid vertex: its
    # smallest entries carry roundoff of the largest's size
    jd = np.asarray(g_j["deform"])
    assert np.isfinite(g_t["deform"].numpy()).all() and np.abs(jd).max() > 0
    np.testing.assert_allclose(g_t["deform"].numpy(), jd, rtol=rtol,
                               atol=max(rtol, 1e-9) * np.abs(jd).max())


@pytest.fixture(scope="module")
def host_pair():
    """Both packages' task with host eigensolves, which leave no state in a
    task: built once, so the JAX side compiles its loss once per bucket."""
    return _tasks(eig_method="host")


@pytest.fixture(scope="module")
def setup(host_pair):
    """Float64 params with a random deform, pretrained (JAX side, 150
    steps) toward a 0.36 ball; the constraint and the target come from a
    0.30 ball, as tests/test_geometry_task.py's optimisation test."""
    j, _ = host_pair
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), j.init_params(jax.random.PRNGKey(1)))
    jp["deform"] = 0.3 * jnp.asarray(np.random.default_rng(7).normal(size=j.grid_verts.shape))
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.5, 0.5, (1500, 3))
    jp = j.pretrain_sdf(jp, q, 0.36 - np.linalg.norm(q, axis=1), iters=150, lr=1e-3)
    sd = 0.30 - np.linalg.norm(q, axis=1)
    out = j._march_params(_shift(jp, -0.06))
    target = np.asarray(j._eigensolve_host(out, JMT.compact(out), MODES + 6)[0][6:])
    return jp, q, sd, target


@pytest.fixture(scope="module")
def jax_step(setup, host_pair):
    """The JAX package's host-path step_loss_grad and the host basis it
    used."""
    jp, q, sd, target = setup
    j, _ = host_pair
    res = j.step_loss_grad(jp, target, jnp.asarray(q), jnp.asarray(sd))
    comp, out = res[3], res[4]
    return res, j._eigensolve_host(out, comp, MODES + 6)[1]


def test_march_and_compaction_equal_jax(setup, jax_step, host_pair):
    jp, *_ = setup
    (*_, cj, oj, _), _ = jax_step
    t = host_pair[1]
    ot = t._march_params(_to_port(jp))
    ct = MarchingTets.compact(ot)
    for k in cj:
        np.testing.assert_array_equal(np.asarray(ct[k]), np.asarray(cj[k]), err_msg=k)
    np.testing.assert_allclose(ot.all_verts.numpy(), np.asarray(oj.all_verts), rtol=0, atol=1e-13)
    assert ct["tets"].shape[0] > ct["num_tets"] and len(ct["keep_idx"]) > ct["num_verts"]


def test_loss_and_gradient_match_jax_value_and_grad(setup, jax_step, host_pair):
    """At JAX's compaction and host basis, with the bucket padding: the
    loss, its parts and the gradient in every MLP parameter and deform
    (the JAX side is its step's jitted value_and_grad of _loss_core)."""
    jp, q, sd, target = setup
    (lj, (tj, ej), gj, cj, _, _), U = jax_step
    t = host_pair[1]
    lt, (tt, et), gt = t.loss_grad(_to_port(jp), cj, U, target, torch.as_tensor(q),
                                   torch.as_tensor(sd), 0.0)
    assert float(tj) > 0 and float(ej) > 0
    np.testing.assert_allclose([lt.item(), tt.item(), et.item()],
                               [float(lj), float(tj), float(ej)], rtol=1e-10)
    _grads_close(gt, gj, 1e-10)


def test_step_loss_grad_matches_jax(setup, jax_step, host_pair):
    """The port's own march, compaction, host ARPACK and pass."""
    jp, q, sd, target = setup
    (lj, (tj, ej), gj, cj, _, timing_j), _ = jax_step
    t = host_pair[1]
    lt, (tt, et), gt, ct, out, timing = t.step_loss_grad(_to_port(jp), target,
                                                        torch.as_tensor(q), torch.as_tensor(sd))
    np.testing.assert_array_equal(ct["tets"], cj["tets"])
    np.testing.assert_allclose([lt.item(), tt.item(), et.item()],
                               [float(lj), float(tj), float(ej)], rtol=1e-8)
    _grads_close(gt, gj, 1e-8)
    assert timing["solve_mode"] == timing_j["solve_mode"] == "host"
    assert {"march_s", "compact_s", "solve_s", "loss_grad_s"} <= set(timing)


def test_optimize_host_path_matches_jax_trajectory(setup, host_pair):
    """Three host-path iterations at lr 3e-4: both packages call ARPACK on
    the same matrices, so the losses agree iteration by iteration."""
    jp, q, sd, target = setup
    j, t = host_pair
    bj, bt = [], []
    pj, best_j, hj = j.optimize(jp, target, q, sd, iters=3, lr=3e-4, verbose=False,
                                on_best=lambda b: bj.append(b["loss"]))
    pt, best_t, ht = t.optimize(_to_port(jp), target, q, sd, iters=3, lr=3e-4, verbose=False,
                                on_best=lambda b: bt.append(b["loss"]))
    assert len(ht) == len(hj) == 3
    for rt, rj in zip(ht, hj):
        for key in ("loss", "template", "eig"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-7, err_msg=key)
    np.testing.assert_allclose(bt, bj, rtol=1e-7)
    # optax's float32 learning rate moves the parameters ~4e-11 apart, and
    # an edge point moves by that change of the SDF over |sdf_a - sdf_b|
    np.testing.assert_allclose(best_t["verts"], best_j["verts"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(best_t["tets"], best_j["tets"])
    want = _to_port(pj)
    for k, v in want["mlp"].items():
        np.testing.assert_allclose(pt["mlp"][k].numpy(), v.numpy(), rtol=1e-7, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_allclose(pt["deform"].numpy(), want["deform"].numpy(), atol=1e-10)


def test_map_only_steps_match_jax_and_reset_the_iteration_count(setup):
    """refresh_every 2: a cold solve, a mapped step (the stored basis
    gathered across a remesh), a warm solve, a mapped step.  The JAX
    package's first two steps give the same losses; a mapped step reports
    no LOBPCG iteration and no residual (the JAX package keeps the last
    warm solve's)."""
    jp, q, sd, target = setup
    j, t = _tasks(eig_method="warm", refresh_every=2)
    # this near-spherical shape's f64 warm solve reaches tol 1e-4 in no
    # fewer than the 240-iteration cap (18 s on two CPU threads); two rounds
    # of 100 reach the acceptance bound (residual 5e-3) and leave it warm
    t.warm.max_iters = 100
    seq = [jp, _shift(jp, 0.003), _shift(jp, 0.006), _shift(jp, 0.009)]
    qj, sdj = jnp.asarray(q), jnp.asarray(sd)
    qt, sdt = torch.as_tensor(q), torch.as_tensor(sd)
    modes, iters = [], []
    for i, p in enumerate(seq):
        lt, _, gt, ct, _, timing = t.step_loss_grad(_to_port(p), target, qt, sdt)
        modes.append(timing["solve_mode"])
        iters.append((timing["solve_iters"], t.warm.last_resid))
        if i < 2:
            lj, _, gj, cj, _, timing_j = j.step_loss_grad(p, target, qj, sdj)
            assert timing_j["solve_mode"] == timing["solve_mode"]
            np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
            _grads_close(gt, gj, 1e-5)
    assert modes == ["cold", "mapped", "warm", "mapped"]
    assert iters[2][0] > 0 and iters[3] == (0, 0.0)
    assert t.warm.total_mapped == 2 and t.warm.total_cold == 1


def test_reanchor_every_forces_a_host_solve(setup):
    """reanchor_every 1: after a warm solve the next solve re-anchors on
    the host."""
    jp, q, sd, target = setup
    t = _tasks(eig_method="warm")[1]
    t.warm.reanchor_every = 1
    t.warm.max_iters = 100  # the cadence is under test (see the map_only test)
    qt, sdt = torch.as_tensor(q), torch.as_tensor(sd)
    modes = [t.step_loss_grad(_to_port(_shift(jp, 0.003 * i)), target, qt, sdt)[-1]["solve_mode"]
             for i in range(4)]
    assert modes == ["cold", "warm", "cold", "warm"]
    assert t.warm.total_cold == 2 and t.warm.warm_count == 1
    assert t.warm.last_resid <= t.warm.accept_resid


def test_a_warm_solve_above_the_acceptance_bound_re_anchors(setup):
    """Two rounds of 40 LOBPCG iterations end above the solver's acceptance
    bound (residual 5e-3): the warm result is dropped, the step's
    eigenvalues are host ARPACK's on the same compaction."""
    jp, q, sd, target = setup
    t = _tasks(eig_method="warm")[1]
    t.warm.max_iters = 40
    qt, sdt = torch.as_tensor(q), torch.as_tensor(sd)
    t.step_loss_grad(_to_port(jp), target, qt, sdt)
    *_, comp, out, timing = t.step_loss_grad(_to_port(_shift(jp, 0.003)), target, qt, sdt)
    assert (timing["solve_mode"], timing["solve_iters"]) == ("cold-escalated", 80)
    want = t._eigensolve_host(out, comp, MODES + 6)[0]
    np.testing.assert_allclose(t.warm.last_vals, want, rtol=1e-10)


def test_solver_failures_are_skipped_counted_and_others_raise(setup, monkeypatch):
    jp, q, sd, target = setup
    _, t = _tasks(eig_method="host")
    calls = []
    real = t._eigensolve_host

    def flaky(out, comp, k):
        calls.append(1)
        if len(calls) == 2:
            raise spla.ArpackNoConvergence("no convergence", np.zeros(0), np.zeros((0, 0)))
        return real(out, comp, k)

    monkeypatch.setattr(t, "_eigensolve_host", flaky)
    _, best, hist = t.optimize(_to_port(jp), target, q, sd, iters=3, lr=3e-4, verbose=False)
    assert [("skipped" in r) for r in hist] == [False, True, False]
    assert "ArpackNoConvergence" in hist[1]["skipped"]
    monkeypatch.setattr(t, "_eigensolve_host",
                        lambda *a: (_ for _ in ()).throw(ValueError("a bug, not a solver")))
    with pytest.raises(ValueError):
        t.optimize(_to_port(jp), target, q, sd, iters=1, verbose=False)


def test_a_step_reads_its_clock_once(setup, monkeypatch):
    """The parts are timed by marks read once, at the end of the step (on
    the card: CUDA events and one sync); the JAX package blocks twice."""
    jp, q, sd, target = setup
    _, t = _tasks(eig_method="host")
    reads = []
    real = gt_mod._Clock.seconds
    monkeypatch.setattr(gt_mod._Clock, "seconds", lambda self: reads.append(1) or real(self))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: reads.append("sync"))
    t.optimize(_to_port(jp), target, q, sd, iters=2, lr=3e-4, verbose=False)
    assert reads == [1, 1]


def _gt_files(tmp_path):
    """A procedural ground truth: an ellipsoid marched and compacted at
    grid 12 as <dir>/egg.msh, its surface as egg_surf.obj."""
    from diffsound_torch.geometry.grid import generate_background_grid

    gv, gtets = generate_background_grid(12)
    gv = gv.astype(np.float64)
    mt = MarchingTets(gv, gtets, device="cpu")
    sdf = 1.0 - np.sqrt(((gv / np.array([0.42, 0.32, 0.26])) ** 2).sum(1))
    out = mt(torch.as_tensor(gv), torch.as_tensor(sdf))
    comp = MarchingTets.compact(out)
    verts = out.all_verts.numpy()[comp["keep_idx"][: comp["num_verts"]]]
    TetMesh(verts, comp["tets"][: comp["num_tets"]]).export(str(tmp_path / "egg.msh"))
    write_obj(str(tmp_path / "egg_surf.obj"), *MarchingTets.compact_triangles(out))


def test_cli_exports_the_first_improvement_and_the_final_best(tmp_path, monkeypatch):
    """The geometry CLI on the CPU at grid 8, voxel 6, 4 modes (200 of its
    2000 pretraining iterations), on a host whose clock reads 5 s since boot: the first
    improvement is written at once (the JAX package seeds its 120 s
    throttle at 0 and would hold it back), and a time-budget stop still
    writes the final best.  Its voxel constraint equals the JAX package's."""
    _gt_files(tmp_path)
    monkeypatch.setattr(gt_mod, "SDFGeometry",
                        lambda *a, **k: SDFGeometry(*a, **dict(k, hidden_dim=HIDDEN)))
    monkeypatch.setattr(geometry_cli.time, "monotonic", lambda: 5.0)
    pretrain = GeometryTask.pretrain_sdf  # 200 of the CLI's 2000 iterations
    monkeypatch.setattr(GeometryTask, "pretrain_sdf",
                        lambda self, *a, **k: pretrain(self, *a, **dict(k, iters=200)))
    exports = []
    real_export = TetMesh.export
    monkeypatch.setattr(TetMesh, "export",
                        lambda self, path: exports.append(os.path.basename(path))
                        or real_export(self, path))
    cfg = tmp_path / "g.json"
    out_dir = tmp_path / "out"
    cfg.write_text(json.dumps({
        "init_mesh_dir": str(tmp_path), "mesh_name_list": ["egg"], "mode_num_list": [4],
        "voxel_num_list": [6], "grid_res": 8, "freq_num": 1, "iter": 3,
        "learning_rate": 3e-4, "out_dir": str(out_dir), "device": "cpu",
        "time_budget_s": 0}))
    results = geometry_cli.main(["--config", str(cfg)])
    (_, _, _, eig_loss, hist), = results
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])  # stopped by the budget
    assert exports == ["egg_4.msh.part", "egg_4.msh"]
    best = TetMesh.from_file(str(out_dir / "6" / "egg_4.msh"))
    assert best.num_tets > 100
    tags = {json.loads(line)["tag"] for line in open(out_dir / "6" / "metrics.jsonl")}
    assert {"egg_4", "egg_4/loss", "egg_4/solve_s", "egg_4/solve_iters"} <= tags

    sv, sf = read_obj(str(tmp_path / "egg_surf.obj"))
    lo, hi = sv.min(0), sv.max(0)
    size = float((hi - lo).max()) * 1.05
    xs = np.linspace(-0.5, 0.5, 6)
    Q = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    sd = j_signed_distance(Q * size, sv - (lo + hi) / 2, sf)
    vv, vt = j_voxel_faces(np.argwhere(sd.reshape(6, 6, 6) > 0), 6)
    got_v, got_t = read_obj(str(out_dir / "6" / "egg_voxel.obj"))
    np.testing.assert_array_equal(got_t, vt)
    np.testing.assert_allclose(got_v, vv / 6 * size - size / 2, rtol=0, atol=1e-8)  # %.9g
