"""The port's flagship forward step (`diffsound_torch/entry.py`) against the
JAX package's entry (`__graft_entry__.py`) on the CPU, on the JAX
entry's own arguments carried across by `convert.entry_args_from_jax`:
cube_tet_mesh(4, 0.5) at order 2 (2,187 DOF), 22 eigen columns, a (1, 8000)
target.

Float64: the JAX side is `_flagship_pieces(jnp.float64)` under the entry's
fn, with the oscillator synthesizing in float64 (the entry's own call
synthesizes in its float32 default), its frequencies and loss jitted and the
synthesis eager (jit turns the float32 time axis's division by the sample
rate into a reciprocal multiply, 1.4e-9 in the loss and 3e-6 in the
gradient away from the division).  Loss and gradient in both bin-logit
groups within 1e-9 relative.

Float32: the entry's jitted fn as `__graft_entry__.py` runs it.  The loss
within 1e-6 relative of it; the gradient, which float32 resolves to about 1% in both
packages here (the rounding of the synthesis and the L1), within 4x the JAX
package's own float32 gap from its float64 gradient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from diffsound_tpu.models.sound_obj import EigenState as JEigenState

from diffsound_torch import entry as entry_mod
from diffsound_torch.audio import synth_kernel
from diffsound_torch.convert import entry_args_from_jax
from diffsound_torch.entry import entry, flagship_pieces

torch.set_num_threads(2)

F32_MARGIN = 4.0


def _jax_f64_value_and_grad():
    model, osc, loss, _ = graft._flagship_pieces(jnp.float64)
    freqs = jax.jit(lambda p, ev, evec: model.get_undamped_freqs(
        p, JEigenState(ev, evec, jnp.asarray(0), jnp.zeros_like(ev))))
    scored = jax.jit(lambda sig, gt, damped: loss(sig, gt, damped, 1.0))

    def fn(params, ev, evec, gt, forces):
        sig, damped = osc(freqs(params, ev, evec), forces, dtype=jnp.float64)
        return scored(sig, gt, damped)

    return jax.value_and_grad(fn)


def _grads(g):
    return {k: np.asarray(v, np.float64) for k, v in g.items()}


@pytest.fixture(scope="module")
def jax_run():
    fn, args = graft.entry()
    loss32, g32 = jax.jit(jax.value_and_grad(fn))(*args)
    args_np = jax.tree.map(np.asarray, args)
    args64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), args_np)
    loss64, g64 = _jax_f64_value_and_grad()(*args64)
    return dict(args=args_np, loss32=float(loss32), g32=_grads(g32), loss64=float(loss64),
                g64=_grads(g64))


def _port(args_np, dtype):
    fn, _ = entry("cpu", dtype=dtype)
    args = entry_args_from_jax(args_np, "cpu", dtype)
    for v in args[0].values():
        v.requires_grad_(True)
    loss = fn(*args)
    loss.backward()
    return float(loss.detach()), {k: v.grad.double().numpy() for k, v in args[0].items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_entry_matches_jax_in_float64(jax_run):
    loss, grads = _port(jax_run["args"], torch.float64)
    assert abs(loss / jax_run["loss64"] - 1) <= 1e-9
    assert set(grads) == set(jax_run["g64"]) == {"youngs_logits", "poisson_logits"}
    for k, g in grads.items():
        assert _rel(g, jax_run["g64"][k]) <= 1e-9, k


def test_entry_matches_jax_in_float32(jax_run):
    loss, grads = _port(jax_run["args"], torch.float32)
    assert abs(loss / jax_run["loss32"] - 1) <= 1e-6
    jax_loss_gap = abs(jax_run["loss32"] / jax_run["loss64"] - 1)
    assert abs(loss / jax_run["loss64"] - 1) <= F32_MARGIN * max(jax_loss_gap, 1e-7)
    for k, g in grads.items():
        jax_gap = _rel(jax_run["g32"][k], jax_run["g64"][k])
        assert 0 < jax_gap < 0.1, k
        assert _rel(g, jax_run["g64"][k]) <= F32_MARGIN * jax_gap, k


def test_entry_args_are_drawn_as_jax_draws_them(jax_run):
    fn, (params, vals, vecs, gt, forces) = entry("cpu", seed=0)
    jparams, jvals, jvecs, jgt, jforces = jax_run["args"]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    # the pieces' dtype on the CPU is float64; the draws are float32 values
    assert vals.dtype == vecs.dtype == gt.dtype == forces.dtype == torch.float64
    np.testing.assert_array_equal(vals.numpy(), jvals.astype(np.float64))
    assert vecs.shape == jvecs.shape == (2187, 22) and gt.shape == jgt.shape == (1, 8000)
    np.testing.assert_array_equal(forces.numpy(), jforces)
    assert abs(vecs.std().item() / 1e-2 - 1) < 0.02 and abs(gt.std().item() / 0.1 - 1) < 0.05
    assert all(float(v.abs().max()) <= 1.0 for v in params.values())
    # the same seed draws the same numbers, another seed others
    again = entry("cpu", seed=0)[1]
    other = entry("cpu", seed=1)[1]
    assert torch.equal(again[2], vecs) and not torch.equal(other[2], vecs)
    assert torch.equal(again[0]["youngs_logits"], params["youngs_logits"])
    # the step runs on its own draws, synthesizing by the plain version here
    before = synth_kernel.LAUNCHES
    assert np.isfinite(float(fn(params, vals, vecs, gt, forces)))
    assert synth_kernel.LAUNCHES == before


def test_flagship_pieces_fall_back_to_the_cube(tmp_path):
    model, osc, loss, forces = flagship_pieces(device="cpu", mesh_path=str(tmp_path / "no.msh"))
    assert model.num_dof == 2187 and model.order == 2 and model.mode_num == 16
    assert (osc.audio_num, osc.mode_num, osc.sample_num, osc.sr) == (1, 16, 8000, 32000.0)
    assert tuple(loss.n_ffts) == (1024, 512, 256, 128, 64) and loss.loss_type == "l1_loss"
    assert forces.shape == (1, 150) and float(forces.sum()) == float(forces[0, 0]) == 1.0


def test_main_prints_the_loss_then_runs_the_dryrun(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr("diffsound_torch.parallel.dryrun.dryrun_multichip",
                        lambda n, device: ran.append((n, device)))
    entry_mod.main(["--device", "cpu"])
    fn, args = entry("cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"entry loss: {float(fn(*args))}"
    assert ran == [(1, "cpu")]
