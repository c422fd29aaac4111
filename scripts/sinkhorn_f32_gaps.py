"""The float32 Sinkhorn divergence's gap to float64 on the geomloss
linear-spectrum clouds of `chip_smoke.lin_clouds` at seeds 11-20 and n_fft
2048 / 1024: the JAX package's (jitted float32 against jitted float64) and
the port's (float32 against float64 on the CPU).  `chip_smoke.py` holds the
card's float32 to JAX_SINKHORN_F32_GAP, which is this script's JAX column.

Each seed's gap is one draw of float32's rounding of potentials of size
|C| ~ 3e5 (an ulp is 0.03 there) against a divergence of 10-60: over the ten
seeds the JAX package's gap spans two orders of magnitude.

Run on the CPU:

    JAX_PLATFORMS=cpu python -m scripts.sinkhorn_f32_gaps

It prints one line per (n_fft, seed) and one JSON line of JAX's gaps."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from diffsound_torch.audio.sinkhorn import sinkhorn_divergence  # noqa: E402
from diffsound_tpu.audio import sinkhorn as jsk  # noqa: E402


def jax_gap(x, y, jitted=jax.jit(jsk.sinkhorn_divergence)):
    """The JAX package's float32 divergence against its float64 on the same
    float32 points x, y (1, n, d) torch tensors."""
    xj, yj = jnp.asarray(x[0].numpy()), jnp.asarray(y[0].numpy())
    v32 = float(jitted(xj, yj))
    v64 = float(jitted(xj.astype(jnp.float64), yj.astype(jnp.float64)))
    return abs(v32 / v64 - 1)


def main():
    torch.set_num_threads(2)
    table = {}
    for n_fft in (2048, 1024):
        table[n_fft] = {}
        for seed in chip_smoke.GEOMLOSS_SEEDS:
            x, y = chip_smoke.lin_clouds(seed, n_fft)
            port = abs(sinkhorn_divergence(x, y).item()
                       / sinkhorn_divergence(x.double(), y.double()).item() - 1)
            table[n_fft][seed] = float(f"{jax_gap(x, y):.4g}")
            print(f"n_fft {n_fft} seed {seed}: JAX {table[n_fft][seed]:.3e}, port {port:.3e}",
                  flush=True)
        print(f"n_fft {n_fft}: JAX median {np.median(list(table[n_fft].values())):.3e}")
    print(json.dumps({"jax_sinkhorn_f32_gap": table}))


if __name__ == "__main__":
    main()
