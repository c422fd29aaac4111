"""Host-side timers and a torch.profiler trace hook.

Counterpart of `diffsound_tpu/utils/profiler.py`: named `tick`/`tock`
timers with a running summary, a context-manager `Timer`, and
`device_trace`, which records a torch.profiler trace of a block and writes
it as a Chrome trace (`trace.json`, readable in chrome://tracing or
Perfetto; no TensorBoard plugin needed).  `block_on` takes a tensor and
synchronizes its CUDA device before the clock is read, so the time covers
the work queued on the card; on the CPU it is a no-op.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_ticks = {}
_accum = defaultdict(float)
_counts = defaultdict(int)


def _sync(block_on):
    if torch.is_tensor(block_on) and block_on.is_cuda:
        torch.cuda.synchronize(block_on.device)


def tick(name: str):
    _ticks[name] = time.perf_counter()


def tock(name: str, block_on=None, verbose: bool = True) -> float:
    """Stop the named timer and return its seconds; `block_on` (a tensor)
    waits for its device first."""
    _sync(block_on)
    dt = time.perf_counter() - _ticks[name]
    _accum[name] += dt
    _counts[name] += 1
    if verbose:
        print(f"[tock] {name}: {dt * 1000:.2f} ms")
    return dt


def timing_summary():
    return {
        k: {"total_s": _accum[k], "count": _counts[k], "mean_ms": 1000 * _accum[k] / _counts[k]}
        for k in _accum
    }


class Timer:
    """Context-manager timer; `block_on` (a tensor) waits for its device at
    exit."""

    def __init__(self, name: str = "", block_on=None, verbose: bool = False):
        self.name = name
        self.block_on = block_on
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.block_on)
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[timer] {self.name}: {self.elapsed * 1000:.2f} ms")


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
