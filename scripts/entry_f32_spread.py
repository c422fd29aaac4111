"""Where the float32 gap of the flagship forward step (`diffsound_torch/entry.py`)
comes from, on the card and on the CPU, at the entry's arguments for several
seeds (cube_tet_mesh(4, 0.5) at order 2, 22 random eigen columns, a random
target).

The step is cut in two: the front (the Rayleigh-corrected frequencies and the
synthesis) and the back (the force convolution's output scored by the
five-scale L1).  Each combination of a front and a back in float32 (the card's
or the CPU's; the signal crosses devices inside autograd) is held against the
CPU's float64 step: the loss's relative gap and the gradient's relative norm
error in each bin-logit group.  The frequencies' float32 error is printed
beside.  At the first seed two controls run on the card: the same step with
TF32 on in every float32 matrix product (the stiffness products of the
Rayleigh correction), and with both synthesis kernels' outputs rounded to
TF32 (`chip_smoke.tf32_rounded_synthesis`).

    python -m scripts.entry_f32_spread [--device cuda|cpu] [--seeds 0 1 ...]

On the CPU (--device cpu) only the CPU's combinations run.  It prints one line
per seed and a JSON line of each combination's gaps: per seed and their
medians over the seeds."""

import argparse
import json

import numpy as np
import torch

from chip_smoke import tf32_rounded_synthesis
from diffsound_torch.entry import entry, flagship_pieces
from diffsound_torch.models.sound_obj import EigenState


def pieces(device, dtype):
    model, osc, loss, forces = flagship_pieces(dtype, device)
    return dict(model=model, osc=osc, loss=loss, forces=forces, device=device, dtype=dtype)


def step(front, back, args):
    """Loss, gradients (float64, CPU) and frequencies (float64, CPU) of the
    step with front's frequencies and synthesis and back's loss."""
    dev, dtype = front["device"], front["dtype"]
    params = {k: v.detach().to(dev, dtype).requires_grad_(True) for k, v in args[0].items()}
    vals, vecs = (x.to(dev, dtype) for x in args[1:3])
    freqs = front["model"].get_undamped_freqs(params, EigenState(vals, vecs, 0,
                                                                  torch.zeros_like(vals)))
    sig, damped = front["osc"](freqs, front["forces"], dtype=dtype)
    to_back = lambda x: x.to(back["device"], back["dtype"])
    loss = back["loss"](to_back(sig), to_back(args[3]), to_back(damped), 1.0)
    loss.backward()
    return (loss.item(), {k: v.grad.double().cpu() for k, v in params.items()},
            freqs.detach().double().cpu())


def gaps(run, ref):
    (loss, grads, freqs), (loss0, grads0, freqs0) = run, ref
    out = {"loss": abs(loss / loss0 - 1)}
    out.update({k: float((grads[k] - g).norm() / g.norm()) for k, g in grads0.items()})
    out["freqs"] = float(((freqs - freqs0).abs() / freqs0).max())
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    opts = parser.parse_args()
    torch.set_num_threads(2)
    ref, cpu = pieces("cpu", torch.float64), pieces("cpu", torch.float32)
    combos = {"cpu f32": (cpu, cpu)}
    if opts.device != "cpu":
        card = pieces(opts.device, torch.float32)
        combos.update({"card f32": (card, card), "card front, cpu back": (card, cpu),
                       "cpu front, card back": (cpu, card)})
    table = {name: {} for name in combos}
    for i, seed in enumerate(opts.seeds):
        _, args = entry("cpu", seed=seed, dtype=torch.float32)
        r64 = step(ref, ref, args)
        for name, (front, back) in combos.items():
            table[name][seed] = gaps(step(front, back, args), r64)
        if i == 0 and opts.device != "cpu":
            torch.set_float32_matmul_precision("high")
            try:
                table["control: TF32 products"] = {seed: gaps(step(card, card, args), r64)}
            finally:
                torch.set_float32_matmul_precision("highest")
            with tf32_rounded_synthesis():
                table["control: TF32-rounded synthesis"] = {seed: gaps(step(card, card, args),
                                                                        r64)}
        print(f"seed {seed}: loss f64 {r64[0]!r}; " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v:.3e}" for k, v in runs[seed].items())
            for name, runs in table.items() if seed in runs), flush=True)
    median = {name: {k: float(np.median([g[k] for g in runs.values()]))
                     for k in next(iter(runs.values()))} for name, runs in table.items()}
    print(json.dumps({"entry_f32_spread": {"seeds": opts.seeds, "per_seed": table,
                                           "median": median}}))


if __name__ == "__main__":
    main()
