"""The program's own spans and counters in one cell, on one card.

    python3 portbench/trace_spans.py --workload <cell> --seed <n> [--rounds 2]

Run from the root of a checkout.  Builds the cell and runs its set-up as
run.py does, then profiles `--rounds` pairs of cycles in turn: one with the
benchmark's spans alone, as a `--trace 1` run profiles its cycle, and one
with the program's `tracing()` open, read by `harness/spans.py`.
Standard error takes each cycle's per-span table and the cost of a span
site with tracing closed; the last line of standard output is one JSON
object: each program-traced cycle's three span readings of the refresh
and its `refresh_active_share`, `span_device`, `idle_spans` and the share
of device time attributed to a `diffsound.*` span, and for every cycle
the mean `portbench.step` wall and the wall a LOBPCG sweep, the cost of
tracing when on.
"""

import argparse
import json
import os
import sys
import time


def span_off_ns(n: int = 200_000, repeat: int = 7) -> float:
    """Nanoseconds a `span()` site costs with tracing closed, over an empty
    `with` of the same no-op context (the least of `repeat` timings of each)."""
    import contextlib
    import timeit

    from diffsound_torch.utils.profiler import span

    noop = contextlib.nullcontext()

    def empty():
        with noop:
            pass

    def site():
        with span("diffsound.step"):
            pass

    best = lambda f: min(timeit.repeat(f, number=n, repeat=repeat)) / n
    return (best(site) - best(empty)) * 1e9


def table(sp: dict) -> str:
    rows = sorted(sp["spans"].items(), key=lambda kv: -kv[1]["device_s"])
    out = [f"{'span':28s} {'calls':>6s} {'wall ms':>10s} {'self ms':>10s} {'device ms':>10s} "
           f"{'launches':>8s} {'inside':>8s} {'idle ms':>9s}"]
    for name, r in rows:
        out.append(f"{name:28s} {r['calls']:6d} {1e3 * r['wall_s']:10.3f} "
                   f"{1e3 * r['self_s']:10.3f} {1e3 * r['device_s']:10.3f} {r['launches']:8d} "
                   f"{r['launches_in']:8d} {1e3 * r['idle_s']:9.3f}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    root = os.getcwd()
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), root]

    import torch

    from harness import spans
    from harness import main as harness

    if not torch.cuda.is_available():
        print("trace_spans: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    spec = harness.cell_spec(root, args.workload)
    drv = harness.driver(spec["cfg"])
    dev = torch.device("cuda")
    inp = drv.make_inputs(spec["cfg"], spec["traffic"], args.seed, dev)
    prog = drv.Program(spec["cfg"], inp, dev)
    prog.setup_steps()
    harness.sync(dev)
    harness.log(f"set-up {time.perf_counter() - t_start:.3f} s")
    dims = drv.dims(spec["cfg"], inp)
    hooks = drv.program_tracing()

    cycles = []
    for r in range(args.rounds):
        for traced in (False, True):
            sp = spans.program_cycle(prog, hooks) if traced else spans.read(
                *spans.profile_cycle(prog))
            sweeps = max(prog.refresh_iters[-1])
            s = sp["spans"]
            row = {"program_spans": traced, "sweeps": sweeps,
                   "step_ms": 1e3 * s["portbench.step"]["wall_s"] / s["portbench.step"]["calls"],
                   "sweep_ms": 1e3 * s["portbench.refresh"]["wall_s"] / sweeps,
                   "window_s": sp["window_s"], "device_s": sp["device_s"]}
            if traced:
                its = prog.refresh_iters[-1]
                row.update(spans.readings(sp, dims), attributed_share=sp["attributed_share"],
                           refresh_active_share=100.0 * sum(its) / (len(its) * sweeps),
                           span_device=sp["span_device"], idle_spans=sp["idle_spans"],
                           counters=sp["counters"])
            harness.log(f"round {r}, program spans {traced}: {json.dumps(row)}\n{table(sp)}")
            cycles.append(row)
    off = span_off_ns()
    harness.log(f"a span site with tracing closed: {off:.1f} ns")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0), "span_off_ns": off,
                      "cycles": cycles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
