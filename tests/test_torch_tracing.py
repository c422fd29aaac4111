"""The port's spans and counters (`diffsound_torch/utils/profiler.py`) in
the multi-pair trainer on the CPU: three pairs on cube_tet_mesh(2, 0.5) at
order 1, one warm refresh and three steps under torch.profiler, with
`tracing()` open and closed."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import torch_parallel_workers as W
from diffsound_torch.parallel.mesh import make_device_mesh
from diffsound_torch.solvers.lobpcg import lobpcg
from diffsound_torch.utils import profiler

torch.set_num_threads(2)

B = 3
# each span and the spans it may sit directly inside (None: outermost)
PARENTS = {
    "diffsound.step": {None},
    "diffsound.refresh": {"diffsound.step"},
    "diffsound.forms": {"diffsound.step"},
    "diffsound.synth": {"diffsound.step"},
    "diffsound.loss": {"diffsound.step"},
    "diffsound.backward": {"diffsound.step"},
    "diffsound.adam": {"diffsound.step"},
    "diffsound.lobpcg.sweep": {"diffsound.refresh"},
    "diffsound.lobpcg.exit": {"diffsound.refresh"},
    "diffsound.lobpcg.orth": {"diffsound.lobpcg.sweep", "diffsound.refresh"},
    "diffsound.lobpcg.eigh": {"diffsound.lobpcg.sweep", "diffsound.refresh"},
    "diffsound.fem.k_apply": {"diffsound.lobpcg.sweep", "diffsound.forms", "diffsound.refresh"},
    "diffsound.fem.m_apply": {"diffsound.lobpcg.sweep", "diffsound.forms", "diffsound.refresh"},
}


def _run(traced: bool) -> dict:
    """Three steps of B pairs, the second with a warm refresh, inside an
    outer `record_function` span as the benchmark sets them, under
    torch.profiler.  The pairs start from bases perturbed by 0, 1e-3 and
    3e-2, so their refreshes take different numbers of iterations."""
    _, trainer, ev, vec, gt = W.port_setup(make_device_mesh(1, 1, "cpu"), refresh_iters=40,
                                           refresh_tol=1e-3)
    params, opt = trainer.init(B, pretrain=False)
    ev, vec = ev[:1].expand(B, -1).clone(), vec[:1].expand(B, -1, -1).clone()
    noise = torch.randn(vec.shape, generator=torch.Generator().manual_seed(0), dtype=vec.dtype)
    vec = vec + torch.tensor([0.0, 1e-3, 3e-2], dtype=vec.dtype)[:, None, None] * noise * \
        vec.abs().max()
    gt = torch.cat([gt, 0.5 * (gt[:1] + gt[1:])])
    losses, before = [], profiler.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.tracing() if traced else contextlib.nullcontext():
            with record_function("portbench.cycle"):
                for refresh in W.REFRESH_AT:
                    params, opt, loss, ev, vec = trainer.step(params, opt, ev, vec, gt,
                                                              refresh=refresh)
                    losses.append(loss)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("diffsound.", "portbench."))]
    return {"events": events, "before": before, "counters": profiler.counters(),
            "its": trainer.last_refresh_iters, "k": vec.shape[2], "losses": torch.stack(losses),
            "eigval": ev, "eigvec": vec}


@pytest.fixture(scope="module")
def runs():
    return {"traced": _run(True), "plain": _run(False)}


def _parent(ev, events):
    """The innermost `diffsound.*` span on ev's thread that holds ev."""
    name, s, t, tid = ev
    holders = [e for e in events if e is not ev and e[0].startswith("diffsound.")
               and e[3] == tid and e[1] <= s and t <= e[2]]
    return max(holders, key=lambda e: (e[1], -e[2]))[0] if holders else None


def test_every_span_appears_and_nests_as_listed(runs):
    events = runs["traced"]["events"]
    ours = [e for e in events if e[0].startswith("diffsound.")]
    assert {e[0] for e in ours} == set(PARENTS)
    for ev in ours:
        assert _parent(ev, ours) in PARENTS[ev[0]], ev[0]
    # the program's spans and the caller's share one timeline
    (_, c0, c1, _), = [e for e in events if e[0] == "portbench.cycle"]
    assert all(c0 <= s and t <= c1 for _, s, t, _ in ours)
    names = [e[0] for e in ours]
    assert names.count("diffsound.step") == 3 and names.count("diffsound.refresh") == 1
    assert names.count("diffsound.lobpcg.sweep") == max(runs["traced"]["its"])


def test_counters_count_sweeps_active_pairs_and_apply_columns(runs):
    r = runs["traced"]
    c, its, cols = r["counters"], r["its"], B * r["k"]
    sweeps = max(its)
    assert len(set(its)) == B  # the pairs leave the batch at different sweeps
    assert c["lobpcg.sweeps"] == sweeps
    assert c["lobpcg.pair_sweeps"] == B * sweeps
    assert c["lobpcg.pair_sweeps_active"] == sum(its) < B * sweeps
    # the solve's set-up applies M to x0 and K to X; each sweep K and M to
    # X (B k columns) and to S = [X | R | P] (3 B k); the forms, at the
    # first step and after the refresh, K twice and M once to B k columns
    assert c["fem.k_apply.calls"] == 1 + 2 * sweeps + 4
    assert c["fem.k_apply.cols"] == cols * (1 + 4 * sweeps + 4)
    assert c["fem.m_apply.calls"] == 1 + 2 * sweeps + 2
    assert c["fem.m_apply.cols"] == cols * (1 + 4 * sweeps + 2)


def test_closed_tracing_records_nothing_and_changes_no_result(runs):
    plain, traced = runs["plain"], runs["traced"]
    assert not [e for e in plain["events"] if e[0].startswith("diffsound.")]
    assert [e[0] for e in plain["events"]] == ["portbench.cycle"]
    assert plain["counters"] == plain["before"]
    assert profiler.span("a") is profiler.span("b")
    assert isinstance(profiler.span("a"), contextlib.nullcontext)
    assert plain["its"] == traced["its"]
    for key in ("losses", "eigval", "eigvec"):
        assert torch.equal(plain[key], traced[key]), key


def test_nested_tracing_keeps_the_outer_counters(tmp_path):
    """lobpcg's profiler option opens `tracing()` inside the caller's: the
    caller's counters go on counting."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(np.diag(np.arange(1.0, 41.0)))
    x0 = torch.as_tensor(rng.standard_normal((40, 4)))
    with profiler.tracing():
        profiler.count("outer", 5)
        res = lobpcg(lambda x: A @ x, lambda x: x, x0, max_iters=6, tol=1e-12,
                     profiler=str(tmp_path))
        c = profiler.counters()
    assert c["outer"] == 5 and c["lobpcg.sweeps"] == res.iterations == 6
    profiler.count("outer")
    assert profiler.counters()["outer"] == 5
