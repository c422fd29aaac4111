"""One traced cycle under torch.profiler, and what is read from its events.

The cycle is the window's own: a refresh, the step that recomputes the
forms, then the 14 plain steps, each inside a `record_function` span of
the benchmark's (`portbench.*`).  Read from the trace, in memory (no file
is written):

  window_s   the length of the `portbench.cycle` span (synced at its end)
  busy_s     the union of the device's kernel, copy and set intervals in it
  launches   kernel launch calls (cudaLaunchKernel, cuLaunchKernel) inside
             each plain step
  kernels    device seconds and calls by kernel name
  idle gaps  the gaps between busy intervals, by the innermost host op or
             span that covered each gap's midpoint
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np
from torch.autograd import DeviceType

DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_NAMES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel"}
HOST_KINDS = {"cpu_op", "user_annotation"}


def traced_cycle(prog) -> dict:
    """Profile one cycle of `prog` (harness.program.Program) and read it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .program import sync

    dev = prog.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts) as prof:
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
    return read(prof.profiler.kineto_results.events(), prog.cycle_len - 1)


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged (n, 2) intervals."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _kind(e) -> str:
    """The event's activity kind; from its device and annotation flag where
    this torch's events do not carry the kind (every device activity that
    is not an annotation then counts as a kernel)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
    return "user_annotation" if e.is_user_annotation() else "cpu_op"


def read(events, plain_steps: int) -> dict:
    spans = defaultdict(list)
    dev, host, launches = [], [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        if name in LAUNCH_NAMES:
            launches.append(s)
            continue
        kind = _kind(e)
        t = s + e.duration_ns()
        if kind in DEVICE_KINDS:
            dev.append((s, t, name))
        elif kind in HOST_KINDS:
            if name.startswith("portbench."):
                spans[name].append((s, t))
            host.append((s, t, name))
    if "portbench.cycle" not in spans:
        return {}
    w0, w1 = spans["portbench.cycle"][0]
    window_s = (w1 - w0) * 1e-9

    kernels = defaultdict(lambda: [0.0, 0])
    iv = []
    for s, t, name in dev:
        if t <= w0 or s >= w1:
            continue
        kernels[name][0] += (t - s) * 1e-9
        kernels[name][1] += 1
        iv.append((max(s, w0), min(t, w1)))
    busy = _union(np.asarray(iv, dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) else 0.0

    lt = np.sort(np.asarray(launches, dtype=np.int64))
    n_launch = sum(int(np.searchsorted(lt, t, "right") - np.searchsorted(lt, s, "left"))
                   for s, t in spans["portbench.step"])

    # idle gaps, named by the innermost host op or span over their midpoint
    host.sort()
    starts = [h[0] for h in host]
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]) if len(busy) else np.array([w0, w1])
    gaps = defaultdict(float)
    for a, b in edges.reshape(-1, 2):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = None
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        if name is None:  # under a long host op: the innermost harness span
            cover = [(t - s, k) for k, v in spans.items() for s, t in v if s <= mid <= t]
            name = min(cover)[1] if cover else "none"
        gaps[name] += (b - a) * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda x: -x[1])[:10]
    return {
        "window_s": window_s, "busy_s": busy_s,
        "launches_per_step": n_launch / plain_steps,
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "device_ops": top({k: v[0] for k, v in kernels.items()}),
        "idle_gaps": top(gaps),
    }


def kernel_time(tr: dict, pattern: str):
    """(device seconds, calls) of the kernels whose name holds `pattern`."""
    s = n = 0
    for name, (sec, calls) in tr.get("kernels", {}).items():
        if pattern in name:
            s, n = s + sec, n + calls
    return s, n
