"""The port's multi-pair trainer against the JAX package's, in f64 at
tests/test_multipair.py's sizes (cube_tet_mesh(2, 0.5) at order 1, 4 modes,
T = 1000, two targets): `lobpcg_batched` against the serial `lobpcg`,
`ShardedFEM` in one process against JAX's assembly, `MultipairTrainer` at
(dp, ep) = (1, 1) from JAX's converted start against JAX's at (1, 1) (L1
steps, an early geomloss step, a refresh), the oscillator's per-row form,
the CLI's `parallel` recipe on the CPU, and the profiler.  The gloo runs
are in tests/test_torch_distributed.py."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.audio.oscillator import TraditionalOscillatorParams as JOsc
from diffsound_tpu.experiments.material_sync import impulse_forces as jforces
from diffsound_tpu.fem import assembly as jassembly
from diffsound_tpu.fem.material import Material as JMaterial
from diffsound_tpu.fem.mesh import cube_tet_mesh as jcube
from diffsound_tpu.models.sound_obj import build_model as jbuild
from diffsound_tpu.parallel.mesh import make_device_mesh as jmesh
from diffsound_tpu.parallel.train import MultipairTrainer as JTrainer
from diffsound_tpu.solvers.diff_eigs import rayleigh_corrected_eigenvalues as jrayleigh
from diffsound_tpu.solvers.diff_eigs import undamped_frequencies as jundamped

import torch_parallel_workers as W
from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
from diffsound_torch.convert import multipair_state_from_jax
from diffsound_torch.experiments import material_sync
from diffsound_torch.fem import assembly
from diffsound_torch.fem.material import Material, lame_params
from diffsound_torch.fem.mesh import cube_tet_mesh, write_msh
from diffsound_torch.parallel.mesh import make_device_mesh
from diffsound_torch.parallel.ops import ShardedFEM, pad_element_ops
from diffsound_torch.solvers.lobpcg import lobpcg, lobpcg_batched

torch.set_num_threads(2)


# -- lobpcg_batched ----------------------------------------------------------


def _pencils():
    """Three scaled pencils of one cube at different materials, as the
    trainer's refresh solves them."""
    mesh = cube_tet_mesh(2, 0.5)
    ops = assembly.build_element_ops(torch.as_tensor(mesh.vertices), mesh.tets, 1)
    fns = []
    for E, nu in ((7.2e10, 0.19), (5e10, 0.3), (9e10, 0.12)):
        mu, lam = lame_params(E / 2700, nu)
        dsc = torch.rsqrt(assembly.k_diag(ops, mu, lam))[:, None]
        fns.append((lambda y, d=dsc, mu=mu, lam=lam: d * assembly.k_matvec(ops, d * y, mu, lam),
                    lambda y, d=dsc: d * assembly.m_matvec(ops, d * y, 1.0)))
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((3 * mesh.num_vertices, 10)))
    return fns, x0


@pytest.mark.parametrize("max_iters", [300, 130])
def test_lobpcg_batched_equals_serial_per_pair(max_iters):
    """Member b of the batched solve is the serial solve of pencil b with
    the same seed: the same iterations, eigenvalues and vectors to 1e-10.
    The pairs converge in different numbers of iterations (127 to 154 at
    tol 1e-8), so the first to finish stays frozen while the others go on;
    at max_iters 130 it converges and the other two stop at the cap."""
    fns, x0 = _pencils()
    serial = [lobpcg(a, b, x0, max_iters=max_iters, tol=1e-8) for a, b in fns]
    res = lobpcg_batched(lambda Y: torch.stack([f[0](y) for f, y in zip(fns, Y)]),
                         lambda Y: torch.stack([f[1](y) for f, y in zip(fns, Y)]),
                         x0.expand(3, -1, -1).clone(), max_iters=max_iters, tol=1e-8)
    its = [r.iterations for r in serial]
    assert res.iterations == its
    assert len(set(its)) > 1 and min(its) < max_iters
    for b, r in enumerate(serial):
        np.testing.assert_allclose(res.eigenvalues[b].numpy(), r.eigenvalues.numpy(),
                                   rtol=1e-10)
        np.testing.assert_allclose(res.eigenvectors[b].numpy(), r.eigenvectors.numpy(),
                                   rtol=0, atol=1e-10 * r.eigenvectors.abs().max().item())
        np.testing.assert_allclose(res.residual_norms[b].numpy(), r.residual_norms.numpy(),
                                   rtol=1e-6)


# -- ShardedFEM in one process -----------------------------------------------


def fem_reference():
    """JAX's assembly on tests/test_parallel.py's problem, pair by pair, and
    the port's unsharded one."""
    mesh, ops, mu, lam, x = W.fem_problem()
    mus, lams = (t.tolist() for t in W.pair_materials(mu, lam))
    jops = jassembly.build_element_ops(jnp.asarray(mesh.vertices), jnp.asarray(mesh.tets), 1,
                                       dtype=jnp.float64)
    jk = lambda X, m, l: np.asarray(jassembly.k_matvec(jops, jnp.asarray(X), m, l))
    jm = lambda X: np.asarray(jassembly.m_matvec(jops, jnp.asarray(X), 1.0))
    d_cols = np.stack([np.asarray(jassembly.k_diag(jops, m, l)) for m, l in zip(mus, lams)], 1)
    s = 1.0 / np.sqrt(d_cols.T[:, :, None])
    jax_ref = {
        "k": np.stack([jk(xb, m, l) for xb, m, l in zip(x, mus, lams)]),
        "k_scaled": np.stack([sb * jk(sb * xb, m, l) for xb, sb, m, l in zip(x, s, mus, lams)]),
        "m": np.stack([jm(xb) for xb in x]),
        "m_scaled": np.stack([sb * jm(sb * xb) for xb, sb in zip(x, s)]),
        "d": np.asarray(jassembly.k_diag(jops, mu, lam)), "d_cols": d_cols,
        "q": np.stack([[(xb * f(xb)).sum(0) for xb in x]
                       for f in (lambda X: jk(X, 1.0, 0.0), lambda X: jk(X, 0.0, 1.0), jm)])}
    X = torch.as_tensor(x)
    port = {"k": torch.stack([assembly.k_matvec(ops, xb, m, l)
                              for xb, m, l in zip(X, mus, lams)]).numpy(),
            "m": torch.stack([assembly.m_matvec(ops, xb, 1.0) for xb in X]).numpy(),
            "d": assembly.k_diag(ops, mu, lam).numpy()}
    return jax_ref, port


def check_fem(got, jax_ref, port_ref):
    assert set(got) == set(jax_ref)
    for key, ref in jax_ref.items():
        np.testing.assert_allclose(got[key], ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max(),
                                   err_msg=key)
        if key in port_ref:
            np.testing.assert_allclose(got[key], port_ref[key], rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max(), err_msg=key)


def test_sharded_fem_at_ep1_matches_jax_assembly():
    check_fem(W.fem_results(make_device_mesh(1, 1, "cpu")), *fem_reference())


def test_pad_element_ops_preserves_matvec():
    mesh, ops, mu, lam, x = W.fem_problem()
    padded = pad_element_ops(ops, 7)
    assert padded.num_tets % 7 == 0 and padded.num_tets > ops.num_tets
    X = torch.as_tensor(x[0])
    np.testing.assert_allclose(assembly.k_matvec(padded, X, mu, lam).numpy(),
                               assembly.k_matvec(ops, X, mu, lam).numpy(), rtol=1e-12)
    fem = ShardedFEM(padded, make_device_mesh(1, 1, "cpu"))
    one = lambda v: torch.tensor([v], dtype=torch.float64)
    np.testing.assert_allclose(fem.k_pairs(X[None], one(mu), one(lam))[0].numpy(),
                               assembly.k_matvec(ops, X, mu, lam).numpy(), rtol=1e-12)


def test_oscillator_rows_form_equals_one_row_at_a_time():
    osc = TraditionalOscillatorParams(1, 4, 500, 32000.0, Material.of(W.BASE))
    f = torch.as_tensor(np.random.default_rng(1).uniform(200, 9000, (3, 4)))
    forces = torch.zeros(1, 20, dtype=torch.float64)
    forces[0, 0] = 1.0
    sig, fd = osc(f, forces, dtype=torch.float64)
    assert sig.shape == (3, 500) and fd.shape == (3, 4)
    for a in range(3):
        s1, fd1 = osc(f[a], forces, dtype=torch.float64)
        np.testing.assert_allclose(sig[a].numpy(), s1[0].numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(fd[a].numpy(), fd1.numpy(), rtol=1e-14)


# -- MultipairTrainer at (1, 1) against JAX's -----------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """JAX's build_setup of tests/test_multipair.py at (1, 1), refresh at 200
    iterations and tol 1e-8, its pretrained logits cast to f64 (f32 logit
    math differs in the last ulp between the packages) with a fresh
    optax state."""
    mesh = jcube(2, size=0.5)
    f64 = jnp.float64
    model = jbuild(mesh=mesh, mode_num=W.MODES, order=1, mat=W.BASE, task="mat_baseline",
                   dtype=f64)
    gt = []
    for t in W.TARGETS:
        gm = jbuild(mesh=mesh, mode_num=W.MODES, order=1, mat=t, task="gt", dtype=f64)
        freqs = gm.get_undamped_freqs({}, gm.eigen_decomposition(method="arpack", sigma=1e5))
        gt.append(JOsc(1, W.MODES, W.T, W.SR, JMaterial.of(t))(
            freqs, jforces(1, W.NF, f64), dtype=f64)[0])
    trainer = JTrainer(bins=model.bins, ops=model.ops,
                       osc=JOsc(1, W.MODES, W.T, W.SR, JMaterial.of(W.BASE)), mesh=jmesh(1, 1),
                       forces=jforces(1, W.NF, f64), sample_rate=W.SR, lr=5e-3,
                       refresh_iters=200, refresh_tol=1e-8)
    eig0 = model.eigen_decomposition(method="arpack", sigma=1e5)
    B = len(W.TARGETS)
    params32, _ = trainer.init(jax.random.PRNGKey(0), B)
    params = jax.tree.map(lambda v: v.astype(f64), params32)
    return dict(trainer=trainer, params=params, opt=jax.vmap(trainer.opt.init)(params),
                eigval=jnp.stack([eig0.eigenvalues] * B), eigvec=jnp.stack([eig0.eigenvectors] * B),
                gt=jnp.stack(gt))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam_np(opt):
    s = opt[0]
    return {"mu": _np(s.mu), "nu": _np(s.nu), "count": np.asarray(s.count)}


def port_from(js, params, opt):
    """The port's (1, 1) trainer on JAX's eigenpairs and targets, from
    JAX's params and optax state."""
    _, trainer, _, _, _ = W.port_setup(make_device_mesh(1, 1, "cpu"), refresh_iters=200,
                                       refresh_tol=1e-8)
    p, o = multipair_state_from_jax(_np(params), _adam_np(opt), trainer.lr,
                                    dtype=torch.float64)
    as_t = lambda a: torch.as_tensor(np.array(a))
    return trainer, p, o, as_t(js["eigval"]), as_t(js["eigvec"]), as_t(js["gt"])


def jax_steps(js, n, params=None, opt=None, **kw):
    params = js["params"] if params is None else params
    opt = js["opt"] if opt is None else opt
    ev, evec = js["eigval"], js["eigvec"]
    losses = []
    for _ in range(n):
        params, opt, loss, ev, evec = js["trainer"].step(params, opt, ev, evec, js["gt"], **kw)
        losses.append(np.asarray(loss))
    return params, opt, np.stack(losses), ev


def _close_params(pt, pj, rtol):
    for k, v in pt.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(pj[k]), rtol=rtol, err_msg=k)


# JAX's trainer synthesizes inside its jitted step, where XLA turns the
# float32 time axis (arange + 1) / sr of `_synth_constant_modes_xla` into a
# multiply by the reciprocal: its signal sits ~4e-8 from JAX's own eager
# synthesis, which the port's matches to ~1e-14
# (test_jax_jitted_synthesis_is_the_loss_gap).  Losses against JAX's trainer
# are held to LOSS_RTOL; the params, which Adam moves by lr * m / sqrt(v),
# and the port's loss against JAX's eager loss, to 1e-9.
LOSS_RTOL = 2e-7


def jax_eager_l1(js, params):
    """JAX's per-pair L1 losses at `params`, evaluated op by op (no jit)."""
    mesh = jcube(2, size=0.5)
    model = jbuild(mesh=mesh, mode_num=W.MODES, order=1, mat=W.BASE, task="mat_baseline",
                   dtype=jnp.float64)
    tr, out = js["trainer"], []
    for b in range(len(W.TARGETS)):
        p = jax.tree.map(lambda v: v[b], params)
        mu, lam = tr.bins.lame(p)
        lams = jrayleigh(lambda x: jassembly.k_matvec(model.ops, x, mu, lam),
                         lambda x: jassembly.m_matvec(model.ops, x, 1.0),
                         js["eigval"][b], js["eigvec"][b])[6:]
        sig, damped = tr.osc(jundamped(lams), tr.forces, dtype=jnp.float64)
        out.append(float(tr.loss(sig, js["gt"][b], damped, 1.0)))
    return np.array(out), sig, damped


def test_jax_jitted_synthesis_is_the_loss_gap(jax_side):
    """Witness for LOSS_RTOL: JAX's trainer's first losses against JAX's
    eager losses at the same start; the port's synthesis against JAX's
    eager and jitted synthesis of the same frequencies.  Run with -s."""
    _, _, lj, _ = jax_steps(jax_side, 1)
    eager, _, damped = jax_eager_l1(jax_side, jax_side["params"])
    osc = jax_side["trainer"].osc
    f = jnp.asarray(np.random.default_rng(3).uniform(300, 9000, W.MODES))
    s_eager = np.asarray(osc(f, None, dtype=jnp.float64)[0])
    s_jit = np.asarray(jax.jit(lambda x: osc(x, None, dtype=jnp.float64)[0])(f))
    port_osc = TraditionalOscillatorParams(1, W.MODES, W.T, W.SR, Material.of(W.BASE))
    s_port = port_osc(torch.as_tensor(np.array(f)), None, dtype=torch.float64)[0].numpy()
    scale = np.abs(s_eager).max()
    trainer_gap = np.abs(lj[0] / eager - 1).max()
    jit_gap = np.abs(s_jit - s_eager).max() / scale
    port_gap = np.abs(s_port - s_eager).max() / scale
    print(f"JAX trainer vs JAX eager loss {trainer_gap:.3e}; synthesis: JAX jit vs eager "
          f"{jit_gap:.3e}, port vs JAX eager {port_gap:.3e}")
    assert 1e-9 < trainer_gap < LOSS_RTOL / 2
    assert jit_gap > 1e-9 and port_gap < 1e-12


def test_three_l1_steps_match_jax(jax_side):
    pj, _, lj, _ = jax_steps(jax_side, 3)
    trainer, p, o, ev, evec, gt = port_from(jax_side, jax_side["params"], jax_side["opt"])
    lt = []
    for _ in range(3):
        p, o, loss, ev, evec = trainer.step(p, o, ev, evec, gt)
        lt.append(loss.numpy())
    np.testing.assert_allclose(lt[0], jax_eager_l1(jax_side, jax_side["params"])[0], rtol=1e-9)
    np.testing.assert_allclose(np.stack(lt), lj, rtol=LOSS_RTOL)
    _close_params(p, pj, 1e-9)
    assert not np.allclose(np.asarray(pj["youngs_logits"]),
                           np.asarray(jax_side["params"]["youngs_logits"]))


def test_step_from_a_converted_adam_state_matches_jax(jax_side):
    """JAX's state after one step, carried into the port (moments and step
    count), then one more step in each package."""
    p1, o1, _, _ = jax_steps(jax_side, 1)
    pj, _, lj, _ = jax_steps(jax_side, 1, params=p1, opt=o1)
    trainer, p, o, ev, evec, gt = port_from(jax_side, p1, o1)
    assert float(o.state[p["youngs_logits"]]["step"]) == 1.0
    p, o, loss, _, _ = trainer.step(p, o, ev, evec, gt)
    np.testing.assert_allclose(loss.numpy(), lj[0], rtol=LOSS_RTOL)
    _close_params(p, pj, 1e-9)


def test_early_geomloss_step_matches_jax(jax_side):
    pj, _, lj, _ = jax_steps(jax_side, 1, early=True)
    trainer, p, o, ev, evec, gt = port_from(jax_side, jax_side["params"], jax_side["opt"])
    p, o, loss, _, _ = trainer.step(p, o, ev, evec, gt, early=True)
    np.testing.assert_allclose(loss.numpy(), lj[0], rtol=LOSS_RTOL)
    _close_params(p, pj, 1e-9)


def test_refresh_step_matches_jax(jax_side):
    """A refresh step at 200 iterations and tol 1e-8: both packages'
    converged eigenvalues, and the step's losses."""
    _, _, lj, evj = jax_steps(jax_side, 1, refresh=True)
    trainer, p, o, ev, evec, gt = port_from(jax_side, jax_side["params"], jax_side["opt"])
    p, o, loss, ev_t, _ = trainer.step(p, o, ev, evec, gt, refresh=True)
    assert all(0 < i < 200 for i in trainer.last_refresh_iters)
    np.testing.assert_allclose(ev_t[:, 6:].numpy(), np.asarray(evj)[:, 6:], rtol=1e-6)
    np.testing.assert_allclose(loss.numpy(), lj[0], rtol=LOSS_RTOL)


# -- the CLI's parallel recipe and the profiler -------------------------------


def _cli_config(tmp_path, **kw):
    mesh = cube_tet_mesh(2, 0.5)
    msh = tmp_path / "cube.msh"
    write_msh(str(msh), mesh.vertices, mesh.tets)
    cfg = dict(mesh_dir=str(msh), out_dir=str(tmp_path / "out"), mode_num=8, sample_rate=32000,
               frame_num=2000, force_frame_num=150, exp_mode=3, parallel=True,
               num_material_pairs=2, max_epoch=16, **kw)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_parallel_cli_on_the_cpu_writes_results(tmp_path):
    material_sync.main(["--config", _cli_config(tmp_path, device="cpu")])
    lines = (tmp_path / "out" / "result.txt").read_text().splitlines()
    assert sum(1 for x in lines if x.startswith("material:")) == 2
    E = [float(x.split(":")[1]) for x in lines if x.startswith("youngs:")]
    assert len(E) == 2 and all(np.isfinite(E)) and all(1e9 < e < 1e12 for e in E)
    rate = float(lines[-1].split(":")[1])
    assert lines[-1].startswith("pair_iters_per_sec:") and rate > 0


def test_parallel_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        material_sync.main(["--config", _cli_config(tmp_path)])


def _spans(trace_dir):
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "diffsound.lobpcg.sweep"
            and e.get("cat") == "user_annotation"]


def test_profiler_timers_and_lobpcg_traces(tmp_path, capsys):
    fns, x0 = _pencils()
    res = lobpcg(*fns[0], x0, max_iters=20, tol=1e-8, profiler=str(tmp_path / "serial"))
    assert res.iterations == 20 and len(_spans(tmp_path / "serial")) == 20
    plain = lobpcg(*fns[0], x0, max_iters=20, tol=1e-8)
    np.testing.assert_array_equal(res.eigenvalues.numpy(), plain.eigenvalues.numpy())
    res = lobpcg_batched(lambda Y: torch.stack([f[0](y) for f, y in zip(fns, Y)]),
                         lambda Y: torch.stack([f[1](y) for f, y in zip(fns, Y)]),
                         x0.expand(3, -1, -1).clone(), max_iters=12, tol=1e-8,
                         profiler=str(tmp_path / "batched"))
    assert res.iterations == [12] * 3 and len(_spans(tmp_path / "batched")) == 12
    out = capsys.readouterr().out
    assert "lobpcg iter 20: max rel resid" in out and "lobpcg iter 12:" in out


def test_parallel_entry_points_run_on_the_card_unless_asked(monkeypatch):
    import inspect

    from diffsound_torch.parallel.dryrun import dryrun_multichip
    from diffsound_torch.render.obj import load_obj

    for entry in (make_device_mesh, dryrun_multichip, load_obj):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_device_mesh(1, 1), lambda: dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert make_device_mesh(1, 1, "cpu").device.type == "cpu"
