"""Spans and counters inside the port, and a torch.profiler trace hook.

`tracing()` is the one switch.  While it is open, `span(name)` is a
`torch.profiler.record_function` scope, so a profiler running around it
records the span in kineto's event stream, on the clock of the CUDA
kernel, copy and launch records, and `count(name, n)` adds n to an
in-memory integer counter that `counters()` returns.  While it is closed,
`span` returns one shared no-op context and `count` returns at once: the
cost at a span site is one flag test.  Counters take only values the host
already holds; none reads the device.

`device_trace` records a torch.profiler trace of a block and writes it as
a Chrome trace (`trace.json`, readable in chrome://tracing or Perfetto; no
TensorBoard plugin needed).
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict

import torch

_NOOP = contextlib.nullcontext()
_on = False
_counts = defaultdict(int)


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block.  The outermost entry
    resets the counters; a nested entry keeps them."""
    global _on
    outer = not _on
    if outer:
        _counts.clear()
    _on = True
    try:
        yield
    finally:
        if outer:
            _on = False


def span(name: str):
    """A `record_function(name)` scope while `tracing()` is open, else a
    shared no-op context."""
    return torch.profiler.record_function(name) if _on else _NOOP


def count(name: str, n: int = 1):
    """Add n to the counter `name` while `tracing()` is open."""
    if _on:
        _counts[name] += n


def counters() -> dict:
    """The counters recorded since the outermost `tracing()` was entered."""
    return dict(_counts)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block (CPU, and CUDA when a card is
    present), written to `<logdir>/trace.json` at exit; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
