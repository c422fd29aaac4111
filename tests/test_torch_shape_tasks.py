"""The port's thickness and morphing tasks against the JAX package's on the
CPU in float64: the Ritz values and dvals/dc from one host basis, the
coefficient bins, one `step_loss_grad` from the JAX package's PRNGKey(0)
bins, Adam and Gauss-Newton trajectories, and the loops' guards (retreat,
cycle break, stall rescue, suspect-step skip, forced anchor) on stubs, as
tests/test_shape_tasks.py checks the JAX package's.  Inputs: icospheres
and an ellipsoid at grids 8-10, fed to both packages as numpy arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.geometry.dmtet import MarchingTets as JMarching
from diffsound_tpu.geometry.tasks import CoefBins as JBins
from diffsound_tpu.geometry.tasks import MorphingTask as JMorphing
from diffsound_tpu.geometry.tasks import ThicknessTask as JThickness

from diffsound_torch import convert
from diffsound_torch.fem.mesh import icosphere
from diffsound_torch.geometry import tasks as tasks_mod
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.tasks import CoefBins, MorphingTask, ThicknessTask

torch.set_num_threads(2)

MAT = (2700, 2.0e11, 0.29, 20, 3e-8)  # Steel, as tests/test_shape_tasks.py
BALL = icosphere(2, radius=0.42)
SMALL = icosphere(2, radius=0.30)
EGG = (BALL[0] * np.array([0.95, 0.7, 0.8]), BALL[1])


def _pair(kind, grid=10, modes=8, eig_method="warm", second=EGG):
    kw = dict(grid_res=grid, scale=1.0, mat=MAT, mode_num=modes, tets_dir="/nonexistent",
              eig_method=eig_method)
    if kind == "thickness":
        j, t = JThickness(**kw), ThicknessTask(**kw, device="cpu")
        j.apply_sdf(*BALL)
        t.apply_sdf(*BALL)
    else:
        j, t = JMorphing(**kw), MorphingTask(**kw, device="cpu")
        j.apply_sdf2(*BALL, *second)
        t.apply_sdf2(*BALL, *second)
    return j, t


def _jax_logits():
    return {k: np.asarray(v) for k, v in JBins(32).init_params(jax.random.PRNGKey(0)).items()}


@pytest.mark.parametrize("kind", ["thickness", "morphing"])
def test_coef_vals_jac_matches_jax(kind):
    """Values and dvals/dc at c = 0.5 on the JAX package's host basis: the
    JAX package's reverse mode against the port's forward mode, float64,
    1e-9 relative (sums over thousands of element contributions in another
    order);
    the port's own host basis gives the same (a rotation within the span)."""
    j, t = _pair(kind, grid=8, eig_method="host")
    c = 0.5
    oj = j._march_coef(jnp.asarray(c))
    cj = JMarching.compact(oj)
    _, Uj = j._eigensolve_host(oj, cj)
    vj, dj = j._coef_vals_jac(c, cj, Uj)
    ot = t._march_coef(c)
    ct = MarchingTets.compact(ot)
    for U in (Uj, t._eigensolve_host(ot, ct)[1]):
        vt, dt = t._coef_vals_jac(c, ct, U)
        assert np.abs(vt / vj - 1).max() <= 1e-9
        assert np.abs(dt - dj).max() <= 1e-9 * np.abs(dj).max()
    assert np.abs(dj).max() > 1e-3 * np.abs(vj).max()
    # values alone, and the derivative against central differences of the
    # frozen-basis program (second order in h)
    assert np.array_equal(t._coef_vals(c, ct, Uj), vt) or \
        np.abs(t._coef_vals(c, ct, Uj) / vt - 1).max() <= 1e-13
    h = 1e-5
    fd = (t._coef_vals(c + h, ct, Uj) - t._coef_vals(c - h, ct, Uj)) / (2 * h)
    assert np.abs(fd - dt).max() <= 1e-4 * np.abs(dt).max()


def test_coef_bins_match_jax():
    logits = _jax_logits()
    jb, tb = JBins(32), CoefBins(32)
    p = convert.params_from_jax(logits, dtype=torch.float64)
    assert tb.coef(p) == pytest.approx(float(jb.value(logits)), rel=1e-14)
    gj = jax.grad(jb.value)({k: jnp.asarray(v) for k, v in logits.items()})["coef_logits"]
    assert np.abs(tb.grad(p, 2.0)["coef_logits"].numpy() - 2.0 * np.asarray(gj)).max() <= 1e-15
    # Adam's first 20 steps agree to 1e-10 (optax and torch.optim round
    # differently); over the full 3000 both hit the target, but the logits
    # then drift apart along the directions that leave the value unchanged
    pj = jb.pretrain({k: jnp.asarray(v) for k, v in logits.items()}, 0.3, steps=20)
    pt = tb.pretrain(p, 0.3, steps=20)
    assert np.abs(pt["coef_logits"].numpy() - np.asarray(pj["coef_logits"])).max() < 1e-10
    assert tb.coef(tb.pretrain(p, 0.5)) == pytest.approx(0.5, abs=1e-6)
    draw = tb.init_params(torch.Generator().manual_seed(0))["coef_logits"]
    assert draw.dtype == torch.float64 and draw.shape == (32,)
    assert bool((draw.abs() <= 1).all())


@pytest.mark.parametrize("kind", ["thickness", "morphing"])
def test_step_loss_grad_from_the_jax_bins(kind):
    """One step of each task from the JAX package's PRNGKey(0) bins, host
    eigensolves in both: loss and logit gradient within 1e-8."""
    j, t = _pair(kind, grid=8, modes=6, eig_method="host")
    target = j.eigenvalues(0.6 if kind == "thickness" else 0.7)
    assert np.abs(t.eigenvalues(0.6 if kind == "thickness" else 0.7) / target - 1).max() < 1e-9
    logits = _jax_logits()
    lj, gj = j.step_loss_grad({k: jnp.asarray(v) for k, v in logits.items()}, jnp.asarray(target))
    lt, gt = t.step_loss_grad(convert.params_from_jax(logits, dtype=torch.float64), target)
    assert float(lt) == pytest.approx(float(lj), rel=1e-8)
    g_j, g_t = np.asarray(gj["coef_logits"]), gt["coef_logits"].numpy()
    assert np.abs(g_t - g_j).max() <= 1e-8 * np.abs(g_j).max()


def test_thickness_adam_trajectory_matches_jax():
    """Four Adam steps from the JAX package's bins (host eigensolves):
    the same losses and coefficients to 1e-7."""
    j, t = _pair("thickness", grid=8, modes=6, eig_method="host")
    target = j.eigenvalues(0.6)
    logits = _jax_logits()
    _, hj = j.optimize(jnp.asarray(target), iters=4, lr=5e-2, verbose=False)
    _, ht = t.optimize(target, iters=4, lr=5e-2, verbose=False,
                       params=convert.params_from_jax(logits, dtype=torch.float64))
    for a, b in zip(hj, ht):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-7)
        assert b["coef"] == pytest.approx(a["coef"], abs=1e-7)
        assert b["skipped"] is a["skipped"] is False
    assert ht[-1]["loss"] < ht[0]["loss"]


def test_morphing_adam_from_a_pretrained_start():
    _, t = _pair("morphing", grid=8, modes=6, eig_method="host")
    target = t.eigenvalues(0.7)
    params, hist = t.optimize(target, iters=3, lr=1e-1, verbose=False, init_coef=0.4)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert abs(hist[-1]["coef"] - 0.7) < abs(0.4 - 0.7)
    assert CoefBins(32).coef(params) == hist[-1]["coef"]


@pytest.mark.parametrize("kind,c0,target,gate", [("thickness", 0.45, 0.6, 0.02),
                                                 ("morphing", 0.4, 0.7, 0.05)])
def test_newton_optimize_ends_where_jax_does(kind, c0, target, gate):
    """Scalar Gauss-Newton in both packages on the same inputs, host
    eigensolves: the same iterates to 1e-7 and the JAX tests' recovery
    gates.  (The warm path's iterates are held to the JAX package's by the
    CLI test.)"""
    j, t = _pair(kind, grid=8, modes=8 if kind == "thickness" else 6, eig_method="host",
                 second=SMALL)
    tgt = j.eigenvalues(target)
    cj, hj = j.newton_optimize(np.asarray(tgt), iters=20, c0=c0, verbose=False)
    ct, ht = t.newton_optimize(tgt, iters=20, c0=c0, verbose=False)
    assert abs(ct - target) < gate and len(ht) < 20
    assert ct == pytest.approx(cj, abs=1e-7)
    assert len(ht) == len(hj)
    for a, b in zip(hj, ht):
        assert b["coef"] == pytest.approx(a["coef"], abs=1e-7)
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-6, abs=1e-12)


def test_order_two_raises():
    with pytest.raises(NotImplementedError, match="order-1"):
        ThicknessTask(grid_res=4, scale=1.0, mat="Steel", mode_num=4, order=2, device="cpu")


# -- the loops' guards on stubs (tests/test_shape_tasks.py, for the port) ----


class _CappedWarmStub:
    """WarmShapeEigensolver's stats surface: a 'warm' refresh whose residual
    never reached the tolerance is the suspect case."""

    def __init__(self):
        self.last_mode = "warm"
        self.last_iterations = 0
        self.last_resid = 0.0
        self.tol = 3e-3
        self.max_iters = 240
        self.total_warm = 0
        self.total_cold = 0
        self.anchor_requests = 0

    def request_anchor(self):
        self.anchor_requests += 1


def _stub_task(monkeypatch, vals_jac=None, true_loss=None, suspect=None):
    task = ThicknessTask(grid_res=4, scale=1.0, mat="Steel", mode_num=4, device="cpu")
    task.warm = _CappedWarmStub()
    comp = {"keep_idx": np.zeros(1, np.int64), "tets": np.zeros((1, 4), np.int64),
            "tet_mask": np.ones(1), "num_verts": 1, "num_tets": 1}
    monkeypatch.setattr(task, "_march_coef", lambda c: None)
    monkeypatch.setattr(tasks_mod.MarchingTets, "compact", staticmethod(lambda out: comp))
    monkeypatch.setattr(task, "_eigensolve", lambda out, comp: (np.ones(4), np.ones((3, 4))))
    if vals_jac:
        monkeypatch.setattr(task, "_coef_vals_jac", vals_jac)
    if true_loss:
        monkeypatch.setattr(task, "_true_loss", lambda c, target: true_loss(c))
    if suspect:
        monkeypatch.setattr(task, "_grad_suspect", suspect)
    return task


def test_adam_skips_suspect_steps_and_anchors_after_three(monkeypatch):
    task = _stub_task(monkeypatch)
    p0 = task.bins.init_params(torch.Generator().manual_seed(0))
    grad = {"coef_logits": torch.ones(32, dtype=torch.float64)}
    calls = {"n": 0}

    def fake_step(params, target):
        calls["n"] += 1
        task.warm.last_resid = 1e-2 if calls["n"] % 2 == 1 else 1e-3
        return torch.tensor(1.0), grad

    monkeypatch.setattr(task, "step_loss_grad", fake_step)
    _, hist = task.optimize(np.ones(4), iters=4, lr=1e-2, verbose=False, params=p0)
    assert [h["skipped"] for h in hist] == [True, False, True, False]
    assert hist[0]["coef"] == pytest.approx(task.bins.coef(p0))
    assert hist[1]["coef"] != pytest.approx(hist[0]["coef"])
    assert hist[2]["coef"] == pytest.approx(hist[1]["coef"])
    assert task.warm.anchor_requests == 0

    task.warm.last_resid = 1e-2  # permanently suspect: anchors at iters 2, 5
    monkeypatch.setattr(task, "step_loss_grad", lambda p, t: (torch.tensor(1.0), grad))
    _, hist = task.optimize(np.ones(4), iters=7, lr=1e-2, verbose=False)
    assert all(h["skipped"] for h in hist) and task.warm.anchor_requests == 2


def test_adam_never_skips_cold_capped_or_converged_warm(monkeypatch):
    task = _stub_task(monkeypatch)
    grad = {"coef_logits": torch.ones(32, dtype=torch.float64)}
    cases = iter([("cold", 0, 0.0), ("warm", 16, 1e-3), ("warm", 240, 2.9e-3),
                  ("cold-escalated", 480, 0.0)])

    def fake_step(params, target):
        task.warm.last_mode, task.warm.last_iterations, task.warm.last_resid = next(cases)
        return torch.tensor(1.0), grad

    monkeypatch.setattr(task, "step_loss_grad", fake_step)
    _, hist = task.optimize(np.ones(4), iters=4, lr=1e-2, verbose=False)
    assert [h["skipped"] for h in hist] == [False] * 4


def test_newton_stall_rescue_reanchors_then_probes(monkeypatch):
    seen = {"n": 0}

    def suspect_once():
        seen["n"] += 1
        return seen["n"] == 1

    true_loss = lambda c: (c - 0.2) ** 2
    task = _stub_task(monkeypatch,
                      vals_jac=lambda c, comp, U: (np.full(4, 1.0 + np.sqrt(true_loss(c))),
                                                   np.zeros(4)),
                      true_loss=true_loss, suspect=suspect_once)
    c, hist = task.newton_optimize(np.ones(4), iters=20, c0=0.26, verbose=False,
                                   probe_step=0.02, loss_floor=1e-6)
    assert task.warm.anchor_requests == 1
    assert c == pytest.approx(0.22, abs=1e-9)
    assert true_loss(c) < true_loss(0.26)


def test_newton_stall_accepts_a_genuine_minimum(monkeypatch):
    true_loss = lambda c: 0.05 + (c - 0.26) ** 2
    task = _stub_task(monkeypatch,
                      vals_jac=lambda c, comp, U: (np.full(4, 1.0 + np.sqrt(true_loss(c))),
                                                   np.zeros(4)),
                      true_loss=true_loss, suspect=lambda: False)
    c, hist = task.newton_optimize(np.ones(4), iters=20, c0=0.26, verbose=False,
                                   probe_step=0.02)
    assert c == pytest.approx(0.26, abs=1e-9) and len(hist) == 1


def test_newton_cycle_break_bisects_and_retreat_halves(monkeypatch):
    task = _stub_task(monkeypatch,
                      vals_jac=lambda c, comp, U: (np.full(4, 1.0 + 0.1 * (c - 0.35)),
                                                   np.full(4, 0.01)),
                      true_loss=lambda c: (0.1 * (c - 0.35)) ** 2, suspect=lambda: False)
    task.warm.last_resid = 1e-4
    c, hist = task.newton_optimize(np.ones(4), iters=6, c0=0.42, max_step=0.08, verbose=False)
    coefs = [h["coef"] for h in hist]
    assert coefs[:3] == pytest.approx([0.42, 0.34, 0.38])
    assert any(h.get("bisect") for h in hist)

    # a loss jump of more than 4x the best retreats halfway to the best
    losses = iter([1e-2, 1.0, 1e-3])
    task = _stub_task(monkeypatch,
                      vals_jac=lambda c, comp, U: (np.full(4, 1.0 + np.sqrt(next(losses))),
                                                   np.full(4, 1.0)),
                      suspect=lambda: False)
    c, hist = task.newton_optimize(np.ones(4), iters=3, c0=0.5, max_step=0.08, verbose=False)
    assert hist[1].get("retreat") and hist[2]["coef"] == pytest.approx(0.5 * (0.42 + 0.5))
    # the budget ran out mid-walk: the best evaluated point is returned
    assert c == pytest.approx(hist[2]["coef"])


@pytest.mark.parametrize("kind", ["thickness", "morphing"])
def test_true_loss_matches_jax(kind):
    """The stall probes' loss, a full march, host eigensolve and Ritz pass
    at c, in both packages: within 1e-9 relative."""
    j, t = _pair(kind, grid=8, modes=6, eig_method="host")
    target = j.eigenvalues(0.6)
    lj = j._true_loss(0.45, np.asarray(target))
    lt = t._true_loss(0.45, target)
    assert lj > 1e-6 and lt == pytest.approx(lj, rel=1e-9)
