"""One run of a cell: inputs, set-up, the window, the traced cycle, the
check, the metrics.  Everything that belongs to one configuration, traffic
mix, cell or metric is found by name:

  BENCHMARK.json                     the cell's configuration, traffic and metrics
  <configs[].file>                   the configuration
  portbench/traffic/<traffic>.json   the traffic mix
  portbench/cells/<cell>.json        the cell's nominal cycle seconds and the
                                     check's limits
  portbench/metrics/<metric>.py      read(ctx) -> the metric's value, or None

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

from . import check, faults, inputs, program, trace

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


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
    return {
        "cell": cell,
        "cfg": load_json(os.path.join(root, conf["file"])),
        "traffic": inputs.check_traffic(traffic),
        "cycle_s": float(own["cycle_s"]), "limits": own["limits"],
        "end_to_end": bench["end_to_end"], "per_layer": layer,
    }


def read_metric(name: str, ctx: dict):
    path = os.path.join(PORTBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def dims(cfg: dict, inp: dict) -> dict:
    return {"B": inp["targets"].shape[0], "M": cfg["mode_num"],
            "k": cfg["mode_num"] + cfg["extra_modes"], "T": cfg["frame_num"],
            "F": cfg["force_frame_num"], "n_ffts": list(cfg["n_ffts"]),
            "E": inp["tets"].shape[0], "nodes": inp["tets"].shape[1], "V": inp["verts"].shape[0]}


def measure(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
            fault=None) -> dict:
    """Set-up, the window and, when traced, the spans and the traced cycle:
    everything but the check.  Returns the run's record."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    dev = torch.device(device)
    t0 = time.perf_counter()
    inp = inputs.make(cfg, traffic, seed, dev)
    t1 = time.perf_counter()
    prog = program.Program(cfg, inp, dev)
    if fault:
        faults.plant(fault, prog)
    t2 = time.perf_counter()
    rec = prog.setup_steps()
    program.sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: imports {t0 - t_start:.3f} s, inputs {t1 - t0:.3f} s, trainer {t2 - t1:.3f} s, "
        f"first steps and a cycle {time.perf_counter() - t2:.3f} s")
    cuda = dev.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda and traced:
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = len(prog.losses)
    spans = {"refresh_s": [], "steps_s": []} if traced else None
    win = program.window(prog, max(1, round(seconds / spec["cycle_s"])), spans)
    win["spans"] = spans
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = trace.traced_cycle(prog) if traced else None
    failed = int((~torch.isfinite(torch.stack(prog.losses[n0:n0 + win["steps"]]))).sum())
    ctx = {"setup_s": setup_s, "window": win, "trace": tr, "dims": dims(cfg, inp),
           "plain_steps": int(cfg["refresh_every"]) - 1,
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
    t0 = time.perf_counter()
    values = check.numbers(m["rec"], m["inputs"], spec["cfg"], torch.device(device))
    log(f"reference check: {time.perf_counter() - t0:.3f} s")
    ok, rows = check.judge(values, spec["limits"])
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
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}  # last
    w = ctx["window"]
    its = w["refresh_iters"]
    log(f"window: {w['cycles']} cycles, {w['steps']} steps, {w['wall_s']:.3f} s; "
        f"LOBPCG sweeps {sum(max(r) for r in its)}, iterations a pair "
        f"{sum(map(sum, its)) / max(1, sum(map(len, its))):.3f}; "
        f"set-up {ctx['setup_s']:.3f} s; failed {m['failed']}")
    return out
