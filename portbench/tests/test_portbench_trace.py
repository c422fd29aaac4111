"""Reading a trace: busy time as the union of device intervals inside the
cycle's span, launches inside the plain steps' spans, kernel time by name,
and idle gaps named by the host op over them.  Events are made by hand, as
a torch without `activity_type` on its events gives them."""

import pytest
from torch.autograd import DeviceType

from harness import trace


class Ev:
    def __init__(self, name, start, dur, cuda=False, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._a = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_read():
    evs = [
        Ev("portbench.cycle", 0, 1000, annotation=True),
        Ev("portbench.cycle", 0, 1000, cuda=True, annotation=True),  # not device work
        Ev("portbench.step", 100, 200, annotation=True),
        Ev("portbench.step", 400, 200, annotation=True),
        Ev("aten::mm", 420, 80),  # inside the second step
        Ev("cudaLaunchKernel", 130, 5),
        Ev("cudaLaunchKernel", 450, 5),
        Ev("cudaLaunchKernel", 700, 5),  # outside the plain steps
        Ev("synth_fwd_kernel", 200, 100, cuda=True),
        Ev("gemm", 250, 100, cuda=True),  # overlaps the synthesis
        Ev("synth_fwd_kernel", 600, 100, cuda=True),
        Ev("late", 1500, 100, cuda=True),  # after the cycle
    ]
    r = trace.read(evs, plain_steps=2)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(250e-9)  # [200, 350] and [600, 700]
    assert r["launches_per_step"] == 1.0
    assert trace.kernel_time(r, "synth_fwd") == (pytest.approx(200e-9), 2)
    assert "late" not in r["kernels"]
    gaps = dict(r["idle_gaps"])  # [0, 200], [350, 600], [700, 1000] by their midpoints
    assert gaps == pytest.approx({"portbench.step": 200e-9, "aten::mm": 250e-9,
                                  "portbench.cycle": 300e-9})
    assert r["device_ops"][0][0] == "synth_fwd_kernel"
