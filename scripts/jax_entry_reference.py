"""The float32 gaps of the flagship forward step (`diffsound_torch/entry.py`,
the JAX package's `__graft_entry__.entry`) at the port's own arguments
(`entry(seed=s)`: its bins' logits, 22 random eigenvectors, a random target
on cube_tet_mesh(4, 0.5) at order 2): the JAX package's jitted float32
loss and gradient in each bin-logit group against its float64 (frequencies
and loss jitted, the synthesis eager and in float64), and the port's
float32 against its float64 on the CPU.  `chip_smoke.py` prints JAX's gap at
the first seed (JAX_ENTRY_F32_GAP, this script's JSON line) beside the card's;
it holds the card to the port's own CPU float32 gap at the same arguments.

The frequencies keep about 1e-7 in float32; the gap is the rounding of the
synthesis, the STFTs and the L1 and their backward (scripts/entry_f32_spread.py
cuts the step in two), so each seed's gap is one draw of an implementation's
order of operations: over ten seeds the gradient's spans 4e-4 to 2e-2 in both
packages.

Run on the CPU (about 15 s):

    JAX_PLATFORMS=cpu python -m scripts.jax_entry_reference [--seeds 0 1 ...]

It prints one line per seed and one JSON line of JAX's gaps at the first
seed and their medians over the seeds."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import __graft_entry__ as graft  # noqa: E402
from diffsound_tpu.models.sound_obj import EigenState  # noqa: E402
from diffsound_torch.entry import entry  # noqa: E402

GROUPS = ("youngs_logits", "poisson_logits")


def jax_step(dtype):
    """The JAX entry's fn on `_flagship_pieces(dtype)`, synthesizing in
    dtype: value and gradient in the params."""
    model, osc, loss, _ = graft._flagship_pieces(dtype)
    freqs = jax.jit(lambda p, ev, evec: model.get_undamped_freqs(
        p, EigenState(ev, evec, jnp.asarray(0), jnp.zeros_like(ev))))
    scored = jax.jit(lambda sig, gt, damped: loss(sig, gt, damped, 1.0))

    def fn(params, ev, evec, gt, forces):
        sig, damped = osc(freqs(params, ev, evec), forces, dtype=dtype)
        return scored(sig, gt, damped)

    step = jax.value_and_grad(fn)
    return jax.jit(step) if dtype == jnp.float32 else step


def port_step(args, dtype):
    fn, _ = entry("cpu", dtype=dtype)
    params = {k: v.detach().to(dtype).requires_grad_(True) for k, v in args[0].items()}
    loss = fn(params, *(x.to(dtype) for x in args[1:]))
    loss.backward()
    return float(loss.detach()), {k: v.grad.double().numpy() for k, v in params.items()}


def gaps(a, b):
    (la, ga), (lb, gb) = a, b
    out = {"loss": abs(la / lb - 1)}
    out.update({k: float(np.linalg.norm(ga[k] - gb[k]) / np.linalg.norm(gb[k])) for k in GROUPS})
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    seeds = parser.parse_args().seeds
    torch.set_num_threads(2)
    steps = {dt: jax_step(dt) for dt in (jnp.float32, jnp.float64)}
    table = {}
    for seed in seeds:
        _, args = entry("cpu", seed=seed, dtype=torch.float32)
        runs = {}
        for dt in (jnp.float32, jnp.float64):
            jargs = ({k: jnp.asarray(v.numpy(), dt) for k, v in args[0].items()},
                     *(jnp.asarray(x.numpy(), dt) for x in args[1:]))
            loss, grad = steps[dt](*jargs)
            runs[dt] = (float(loss), {k: np.asarray(v, np.float64) for k, v in grad.items()})
        jax_gap = gaps(runs[jnp.float32], runs[jnp.float64])
        port64 = port_step(args, torch.float64)
        port_gap = gaps(port_step(args, torch.float32), port64)
        table[seed] = {k: float(f"{v:.4g}") for k, v in jax_gap.items()}
        print(f"seed {seed}: loss f64 JAX {runs[jnp.float64][0]:.12g} port {port64[0]:.12g}; "
              f"f32 gaps JAX {jax_gap}, port {port_gap}", flush=True)
    median = {k: float(f"{np.median([t[k] for t in table.values()]):.4g}") for k in table[seeds[0]]}
    print(json.dumps({"jax_entry_f32_gap": {"seed": seeds[0], "at_seed": table[seeds[0]],
                                            "median": median}}))


if __name__ == "__main__":
    main()
