"""Readings that the check's limits are set from, at a cell's own size, in
one process (the seed-independent inputs are made once):

  program   sound runs on many seeds (the lower readings)
  control   the program with TF32 switched back on for its float32
            products, the precision below the one the configuration states
  faults    each fault of the cell's driver planted under the timed path

Each run drives set-up (the recipe's first 15 steps and one cycle) and
one window cycle, then the reference check.  No metric is reported.

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 --fault-seeds 201-203 --out <file.json>
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), root]

    import torch

    from harness import main as harness

    spec = harness.cell_spec(root, args.workload)
    drv = harness.driver(spec["cfg"])
    plan = [("program", None, s) for s in seeds(args.seeds)]
    plan += [("control", None, s) for s in seeds(args.control_seeds)]
    plan += [("fault", f, s) for f in drv.FAULTS for s in seeds(args.fault_seeds)]
    rows = []
    for kind, fault, seed in plan:
        set_tf32(kind == "control")
        t0 = time.perf_counter()
        m = harness.measure(spec, seed, 0.0, False, "cuda", t0, fault)
        values = drv.numbers(m["rec"], m["inputs"], spec["cfg"], torch.device("cuda"),
                             unpinned=True)
        drv.heal()
        row = {"kind": kind, "fault": fault, "seed": seed, "numbers": values,
               "refresh_iters": m["ctx"]["window"]["refresh_iters"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del m
    set_tf32(False)
    summary = {}
    for kind in ("program", "control"):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {k: [min(g[k] for g in got), max(g[k] for g in got)] for k in got[0]}
    for f in drv.FAULTS:
        got = [r["numbers"] for r in rows if r["fault"] == f]
        if got:
            summary[f] = {k: [min(g[k] for g in got), max(g[k] for g in got)] for k in got[0]}
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "rows": rows, "summary": summary,
           "seconds": time.perf_counter() - T_START}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
