"""What the float64 exp-sum of `diffsound_torch.audio.sinkhorn._logsumexp`
costs on the card: the Sinkhorn divergence and its gradient at the geomloss
step's shapes at 8 mics (a batch of 8 clouds of n_fft // 2 + 1 points, 4
features, n_fft 2048 and 1024; the clouds are `chip_smoke.lin_clouds` at
seeds 11-18), with the port's float64 sum and with the float32 sum it
replaced, in turns (f32, f64, f64, f32, ...), in one process on one card:
device ms per divergence-and-gradient (CUDA events) and peak memory.

Run on a machine with a GPU:

    python -m scripts.sinkhorn_sum_cost

It prints the card's name and power limit, one line per variant and n_fft,
and one JSON line."""

import json
import statistics

import torch

import chip_smoke
from diffsound_torch.audio import sinkhorn


def lse_f32_sum(x, dim):
    """The float32 exp-sum `_logsumexp` had before (detached max)."""
    m = x.detach().amax(dim=dim, keepdim=True)
    return (x - m).exp().sum(dim=dim).log() + m.squeeze(dim)


def run(x, y):
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(sinkhorn.sinkhorn_divergence(xg, y).sum(), xg)
    return g


def main(rounds: int = 4, calls: int = 3):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    variants = {"f64 sum": sinkhorn._logsumexp, "f32 sum": lse_f32_sum}
    out = {}
    for n_fft in (2048, 1024):
        clouds = [chip_smoke.lin_clouds(s, n_fft) for s in chip_smoke.GEOMLOSS_SEEDS[:8]]
        x = torch.cat([c[0] for c in clouds]).to(dev)
        y = torch.cat([c[1] for c in clouds]).to(dev)
        ms = {k: [] for k in variants}
        peak = {}
        order = ["f32 sum", "f64 sum", "f64 sum", "f32 sum"] * (rounds // 2)
        for name in ["f32 sum", "f64 sum"] + order:  # the first two warm up
            sinkhorn._logsumexp = variants[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(calls):
                run(x, y)
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / calls)
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        sinkhorn._logsumexp = variants["f64 sum"]
        row = {k: {"ms_median": statistics.median(v[1:]), "ms": v[1:], "peak_gib": peak[k]}
               for k, v in ms.items()}
        for k, r in row.items():
            chip_smoke.log(f"n_fft {n_fft}, batch 8, {k}: divergence and gradient "
                           f"{r['ms_median']:.3f} ms (rounds {chip_smoke.fmt(r['ms'], 3)}), peak "
                           f"{r['peak_gib']:.3f} GiB")
        chip_smoke.log(f"n_fft {n_fft}: the float64 sum costs "
                       f"{row['f64 sum']['ms_median'] / row['f32 sum']['ms_median'] - 1:+.1%} "
                       f"device time")
        out[n_fft] = row
    print(json.dumps({"sinkhorn_sum_cost": out}))


if __name__ == "__main__":
    main()
