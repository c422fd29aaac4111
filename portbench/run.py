"""The benchmark of diffsound_torch on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name (see harness/main.py).  With --trace 0
the last line of standard output is the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, in one JSON object: correct, attempted,
failed, metrics, device[, breakdown], checks.  The checks' numbers and
limits are also the last lines of standard error.  Exits non-zero, and
prints no result, without a CUDA card, with fewer cards than the cell asks
for, when the program cannot be imported, or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "diffsound_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.getcwd()
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    # Bytecode of every module imported from here on, torch's among them, is
    # kept inside the checkout: where the installed packages carry none and
    # cannot take any, each run would otherwise compile them all anew.
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), root]

    import torch

    from harness import main as harness

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    spec = harness.cell_spec(root, args.workload)
    chips = int(spec["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), **out["device"]}
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
