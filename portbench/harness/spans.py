"""The program's own spans and counters, read from one more profiled cycle.

`program_cycle` profiles a cycle as `trace.traced_cycle` does, with the
program's tracing open, as its driver's `program_tracing()` hands it: a
`tracing()` context, a `counters()` reader and the prefix of its span
names (for diffsound_torch, `diffsound_torch.utils.profiler` and
"diffsound.").  The program's spans (`record_function` scopes) then land in
kineto's event stream beside the benchmark's `portbench.*` spans and the
CUDA runtime and device records, on one clock.  Read from it, in memory:

  attribution  each kernel, copy and set goes to its runtime call by
               correlation id; the call goes to the innermost program
               span that covers its start, on any thread (the autograd
               thread launches the backward while the main thread waits
               inside `diffsound.backward`); else to the innermost
               `portbench.*` span; else to "none"
  per span     calls, wall, self time (wall less what its child spans on
               its thread cover), attributed device seconds, kernel
               launches attributed (`launches`) and inside its intervals
               (`launches_in`), idle seconds
  idle gaps    between the device's busy intervals inside `portbench.cycle`,
               named as a launch is, by the gap's midpoint
  counters     the program's, as `counters()` returns them

`readings` turns that into three numbers of the batched refresh.  A driver
whose program has no tracing gives None.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import numpy as np

from counts import element_apply, peaks

from .trace import DEVICE_KINDS, HOST_KINDS, LAUNCH_NAMES, _kind, _union

RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}
APPLY_SPANS = ("diffsound.fem.k_apply", "diffsound.fem.m_apply")


def _runtime(kind: str, name: str) -> bool:
    """A CUDA runtime or driver call; by its name where this torch's events
    carry no kind (`trace._kind` then calls it a "cpu_op")."""
    return kind in RUNTIME_KINDS or (kind == "cpu_op" and name.startswith("cu"))


def profile_cycle(prog, hooks=None):
    """One cycle of `prog` under torch.profiler, in `trace.traced_cycle`'s
    spans and synchronises; with `hooks` (a driver's `program_tracing()`),
    inside the program's `tracing()`.  Returns (events, counters)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .program import sync

    dev = prog.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts) as prof:
        with hooks["tracing"]() if hooks else contextlib.nullcontext():
            with record_function("portbench.cycle"):
                with record_function("portbench.refresh"):
                    prog.refresh()
                    sync(dev)
                with record_function("portbench.first_step"):
                    prog.step()
                    sync(dev)
                for _ in range(prog.cycle_len - 1):
                    with record_function("portbench.step"):
                        prog.step()
                sync(dev)
            ctr = hooks["counters"]() if hooks else {}
    return prof.profiler.kineto_results.events(), ctr


def program_cycle(prog, hooks):
    """`read` of one cycle of `prog` traced with `hooks`, its driver's
    `program_tracing()`; None where that is None."""
    if hooks is None:
        return None
    return read(*profile_cycle(prog, hooks), prefix=hooks["prefix"])


class _Innermost:
    """The innermost of a set of spans (the latest to start, then the
    shortest) over any instant, from a sweep over their edges."""

    def __init__(self, spans):
        edges = sorted([(s, 1, i) for i, (_, s, _, _) in enumerate(spans)]
                       + [(t, 0, i) for i, (_, _, t, _) in enumerate(spans)])
        active, self.times, self.names = {}, [], []
        for x, opens, i in edges:
            if opens:
                active[i] = spans[i]
            else:
                active.pop(i, None)
            inner = max(active.values(), key=lambda sp: (sp[1], -sp[2]), default=None)
            self.times.append(x)
            self.names.append(inner[0] if inner else None)

    def at(self, x):
        j = bisect.bisect_right(self.times, x) - 1
        return self.names[j] if j >= 0 else None


def _self_seconds(spans) -> dict:
    """Each span name's wall less what its child spans on its thread cover
    (spans on one thread nest)."""
    out = defaultdict(float)
    by_thread = defaultdict(list)
    for sp in spans:
        by_thread[sp[3]].append(sp)
    for group in by_thread.values():
        group.sort(key=lambda sp: (sp[1], -sp[2]))
        stack = []  # [name, end, wall less its children so far]
        for name, s, t, _ in group:
            while stack and stack[-1][1] <= s:
                top = stack.pop()
                out[top[0]] += top[2]
            if stack:
                stack[-1][2] -= t - s
            stack.append([name, t, t - s])
        for top in stack:
            out[top[0]] += top[2]
    return {k: v * 1e-9 for k, v in out.items()}


def read(events, counters: dict, prefix: str = "diffsound.") -> dict:
    """The cycle's table (module docstring) from its kineto `events`, the
    program's `counters` and the `prefix` of the program's span names."""
    spans, bench, dev, runtime, launches = [], [], [], {}, []
    for e in events:
        name, s = e.name(), e.start_ns()
        kind = _kind(e)
        t = s + e.duration_ns()
        if kind in DEVICE_KINDS:
            dev.append((s, t, e.correlation_id()))
        elif _runtime(kind, name):
            runtime[e.correlation_id()] = s
            if name in LAUNCH_NAMES:
                launches.append(s)
        elif kind in HOST_KINDS:
            if name.startswith(prefix):
                spans.append((name, s, t, e.start_thread_id()))
            elif name.startswith("portbench."):
                bench.append((name, s, t, e.start_thread_id()))
    cycle = [(s, t) for name, s, t, _ in bench if name == "portbench.cycle"]
    if not cycle:
        return {}
    w0, w1 = cycle[0]
    inner, outer = _Innermost(spans), _Innermost(bench)
    owner = lambda x: inner.at(x) or outer.at(x) or "none"

    table = defaultdict(lambda: dict(calls=0, wall_s=0.0, self_s=0.0, device_s=0.0, launches=0,
                                     launches_in=0, idle_s=0.0))
    lt = np.sort(np.asarray(launches, dtype=np.int64))
    for name, s, t, _ in spans + bench:
        row = table[name]
        row["calls"] += 1
        row["wall_s"] += (t - s) * 1e-9
        row["launches_in"] += int(np.searchsorted(lt, t, "right") - np.searchsorted(lt, s, "left"))
    for name, sec in _self_seconds(spans + bench).items():
        table[name]["self_s"] = sec
    for x in launches:
        table[owner(x)]["launches"] += 1

    iv, device_s = [], 0.0
    for s, t, corr in dev:
        if t <= w0 or s >= w1:
            continue
        sec = (min(t, w1) - max(s, w0)) * 1e-9
        device_s += sec
        table[owner(runtime.get(corr, s))]["device_s"] += sec
        iv.append((max(s, w0), min(t, w1)))
    busy = _union(np.asarray(iv, dtype=np.int64).reshape(-1, 2))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]) if len(busy) else np.array([w0, w1])
    for a, b in edges.reshape(-1, 2):
        if b > a:
            table[owner((a + b) // 2)]["idle_s"] += float(b - a) * 1e-9

    ours = {k: v for k, v in table.items() if k.startswith(prefix)}
    attributed = sum(v["device_s"] for v in ours.values())
    top = lambda key, rows: sorted(([k, v[key]] for k, v in rows.items() if v[key] > 0),
                                   key=lambda x: -x[1])[:10]
    return {
        "spans": dict(table), "counters": dict(counters),
        "window_s": (w1 - w0) * 1e-9, "device_s": device_s,
        "attributed_share": 100.0 * attributed / device_s if device_s else None,
        "span_device": top("device_s", ours),
        "idle_spans": top("idle_s", table),
    }


def readings(sp: dict, dims: dict) -> dict:
    """The batched refresh's numbers in a program-traced cycle `sp`
    (`read`'s), at the cell's `dims` (its driver's); each None where
    the cycle holds nothing to read it from, as on a host without a card.

    apply_roofline (%): the element applies' bound, `counts/element_apply.py`
      (`count` for K, `mass_count` for M) at each kind's mean columns a
      call, through `peaks.bound_s`, times its calls, over the device
      seconds attributed to the two apply spans.  The bound is affine in
      the columns within one regime, and at the cells' sizes every call of
      a kind lies on one side of its balance: a call takes B k columns or
      3 B k (352 or 1,056 at 16 pairs), where K turns from bytes-bound to
      operations-bound at about 134 columns (order 2) or 120 (order 1),
      and M at order 1 at about 110, while M at order 2 is bytes-bound at
      any width.  So the mean gives the exact sum.
    eigh_ms (ms): the device seconds attributed to the
      `diffsound.lobpcg.eigh` spans (the kernels and copies that the
      float64 `eigh`s launch) over `lobpcg.sweeps`.  Not the span's wall:
      `torch.linalg.eigh` synchronises, so the wall holds the sweep's
      device backlog.
    sweep_launches (launches): kernel launches inside the
      `diffsound.lobpcg.sweep` spans over `lobpcg.sweeps`.
    """
    out = dict.fromkeys(("apply_roofline", "eigh_ms", "sweep_launches"))
    if not sp:
        return out
    c, s = sp["counters"], sp["spans"]
    dev = sum(s[n]["device_s"] for n in APPLY_SPANS if n in s)
    bound = 0.0
    for kind, fn in (("k", element_apply.count), ("m", element_apply.mass_count)):
        calls = c.get(f"fem.{kind}_apply.calls", 0)
        if calls:
            cols = c[f"fem.{kind}_apply.cols"] / calls
            bound += calls * peaks.bound_s(*fn(dims["E"], dims["nodes"], cols, dims["V"]))
    if dev > 0 and bound > 0:
        out["apply_roofline"] = 100.0 * bound / dev
    sweeps = c.get("lobpcg.sweeps", 0)
    if sweeps:
        eigh = s.get("diffsound.lobpcg.eigh", {}).get("device_s", 0.0)
        if eigh > 0:
            out["eigh_ms"] = 1e3 * eigh / sweeps
        if "diffsound.lobpcg.sweep" in s:
            out["sweep_launches"] = s["diffsound.lobpcg.sweep"]["launches_in"] / sweeps
    return out
