"""One run of a cell: inputs, set-up, the window, the traced cycles, the
check, the metrics.  Everything that belongs to one configuration, traffic
mix, cell or metric is found by name:

  BENCHMARK.json                     the cell's configuration, traffic and metrics
  <configs[].file>                   the configuration; its key "driver" names
                                     the driver (default "multipair_l1")
  portbench/drivers/<driver>.py      what is particular to the configuration's
                                     program, inputs and check (below)
  portbench/traffic/<traffic>.json   the traffic mix
  portbench/cells/<cell>.json        the cell's nominal cycle seconds and the
                                     check's limits
  portbench/metrics/<metric>.py      read(ctx) -> the metric's value, or None

A driver module defines:

  TRAFFIC_KEYS    the traffic keys it reads; a traffic file with any other
                  key is refused
  make_inputs(cfg, traffic, seed, device) -> dict
                  every input of a run, handed alike to the program and to
                  the reference
  Program(cfg, inputs, device)
                  the system under test, with `device`, `pairs` (rows a step
                  trains), `cycle_len` (steps a cycle), `losses` (each
                  step's losses on the device), `refresh_iters` (each
                  refresh's iterations a pair), `refresh()` (a no-op where the
                  recipe has no separate refresh), `step()`, `cycle(spans)`
                  (a refresh and its steps; spans, a dict of lists, takes the
                  synced seconds of the refresh, "refresh_s", and of the
                  steps after the first, "steps_s") and `setup_steps() -> rec`
                  (the set-up's steps, recording on the host what the check
                  compares)
  dims(cfg, inputs) -> dict
                  the sizes that metric files and portbench/counts/ read
  NAMES, numbers(rec, inputs, cfg, device, unpinned=False) -> dict
                  the numbers the check compares, against the plain
                  reference; the cell file gives a limit to each of NAMES
  FAULTS, plant(name, prog), heal()
                  faults planted under the timed path, for calibrate.py and
                  the benchmark's tests; heal undoes what plant patched
                  beyond `prog`
  program_tracing() -> dict or None
                  the program's own spans and counters: {"tracing": a
                  context manager factory that turns them on, "counters":
                  a function returning them, "prefix": the spans' name
                  prefix}; None where the program has none.  A traced run
                  profiles one more cycle with them (harness/spans.py)

A driver may import and reuse harness/ and reference/.  A configuration is
added with new files alone: its file, a driver, reference files, a traffic
file, a cell file and entries in BENCHMARK.json.

The window is a fixed amount of work: round(seconds / cycle_s) whole
cycles, cycle_s the cell's cycle on the H100 it was defined on.  A window
that ran until the clock passed `seconds` would hold more cycles on a
faster host, and later cycles refresh in fewer LOBPCG iterations than
early ones, so its rate would swing with the host.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import torch

from . import check, spans, trace
from .program import sync, window

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DRIVER = "multipair_l1"
DRIVER_DIRS = (os.path.join(PORTBENCH, "drivers"),)  # searched in order


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def driver(cfg: dict):
    """The driver module that the configuration `cfg` names, loaded once a
    process from the first of DRIVER_DIRS that holds it."""
    name = cfg.get("driver", DEFAULT_DRIVER)
    paths = [os.path.join(d, f"{name}.py") for d in DRIVER_DIRS]
    path = next((p for p in paths if os.path.isfile(p)), None)
    if path is None:
        raise FileNotFoundError(f"no driver {name!r}: looked for {' and '.join(paths)}")
    key = f"portbench_driver_{name.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is None or mod.__file__ != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return mod


def check_traffic(traffic: dict, drv) -> dict:
    """The traffic mix as read, refused if it holds a key that the driver
    does not read."""
    unknown = sorted(set(traffic) - set(drv.TRAFFIC_KEYS))
    if unknown:
        raise ValueError(f"traffic keys {unknown} are not read by the driver {drv.__file__} "
                         f"(it reads {sorted(drv.TRAFFIC_KEYS)})")
    return traffic


def cell_spec(root: str, name: str) -> dict:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic, limits and metric entries."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            raise ValueError(f"end-to-end metric {m['name']!r} names workloads: every cell "
                             "of this harness reports every end-to-end metric")
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']!r} names no workloads")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    own = load_json(os.path.join(PORTBENCH, "cells", f"{name}.json"))
    traffic = load_json(os.path.join(PORTBENCH, "traffic", f"{cell['traffic']}.json"))
    cfg = load_json(os.path.join(root, conf["file"]))
    return {
        "cell": cell,
        "cfg": cfg,
        "traffic": check_traffic(traffic, driver(cfg)),
        "cycle_s": float(own["cycle_s"]), "limits": own["limits"],
        "end_to_end": bench["end_to_end"], "per_layer": layer,
    }


def read_metric(name: str, ctx: dict):
    path = os.path.join(PORTBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def measure(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
            fault=None) -> dict:
    """Set-up, the window and, when traced, the spans and the two traced
    cycles (the benchmark's spans alone, then the program's own as well):
    everything but the check.  Returns the run's record."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    drv = driver(cfg)
    dev = torch.device(device)
    t0 = time.perf_counter()
    inp = drv.make_inputs(cfg, traffic, seed, dev)
    t1 = time.perf_counter()
    prog = drv.Program(cfg, inp, dev)
    if fault:
        drv.plant(fault, prog)
    t2 = time.perf_counter()
    rec = prog.setup_steps()
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: imports {t0 - t_start:.3f} s, inputs {t1 - t0:.3f} s, trainer {t2 - t1:.3f} s, "
        f"first steps and a cycle {time.perf_counter() - t2:.3f} s")
    cuda = dev.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda and traced:
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = len(prog.losses)
    win_spans = {"refresh_s": [], "steps_s": []} if traced else None
    win = window(prog, max(1, round(seconds / spec["cycle_s"])), win_spans)
    win["spans"] = win_spans
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = sp = None
    if traced:
        t3 = time.perf_counter()
        tr = trace.traced_cycle(prog)
        t4 = time.perf_counter()
        sp = spans.program_cycle(prog, drv.program_tracing())
        log(f"traced cycles: profiled {t4 - t3:.3f} s, with the program's spans "
            f"{time.perf_counter() - t4:.3f} s")
    failed = int((~torch.isfinite(torch.stack(prog.losses[n0:n0 + win["steps"]]))).sum())
    ctx = {"setup_s": setup_s, "window": win, "trace": tr, "spans": sp,
           "dims": drv.dims(cfg, inp), "plain_steps": prog.cycle_len - 1,
           "peak_window_bytes": peak_window if traced else None}
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"ctx": ctx, "rec": rec, "inputs": inp, "failed": failed,
            "peak_bytes": max(peak_setup, peak_window)}


def run(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        fault=None) -> dict:
    """A whole run; returns the result object (without the platform check)."""
    m = measure(spec, seed, seconds, traced, device, t_start, fault)
    ctx = m["ctx"]
    entries = spec["per_layer"] if traced else spec["end_to_end"]
    metrics = {}
    for e in entries:
        v = read_metric(e["name"], ctx)
        if v is not None:
            metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}
    drv = driver(spec["cfg"])
    t0 = time.perf_counter()
    values = drv.numbers(m["rec"], m["inputs"], spec["cfg"], torch.device(device))
    log(f"reference check: {time.perf_counter() - t0:.3f} s")
    ok, rows = check.judge(values, spec["limits"], drv.NAMES)
    ok = ok and m["failed"] == 0
    out = {
        "correct": bool(ok),
        "attempted": int(ctx["window"]["pair_iters"]),
        "failed": int(m["failed"]),
        "metrics": metrics,
        "device": {"count": 1, "memory_peak_bytes": int(m["peak_bytes"])},
    }
    tr = ctx["trace"]
    if tr:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        if ctx["spans"]:
            out["breakdown"].update(span_device=ctx["spans"]["span_device"],
                                    idle_spans=ctx["spans"]["idle_spans"])
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}  # last
    w = ctx["window"]
    its = w["refresh_iters"]
    log(f"window: {w['cycles']} cycles, {w['steps']} steps, {w['wall_s']:.3f} s; "
        f"LOBPCG sweeps {sum(max(r) for r in its)}, iterations a pair "
        f"{sum(map(sum, its)) / max(1, sum(map(len, its))):.3f}; "
        f"set-up {ctx['setup_s']:.3f} s; failed {m['failed']}")
    return out
