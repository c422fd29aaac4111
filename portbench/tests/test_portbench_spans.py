"""Reading the program's own spans (`harness/spans.py`): device time and
launches put down to the innermost `diffsound.*` span by correlation id,
across threads; self time; idle gaps by span; the three span readings of
the refresh.
Events are made by hand, with and without their kind, and one cycle of a
CPU-sized program is traced."""

import sys
import types

import pytest
from torch.autograd import DeviceType

from conftest import tiny_spec
from counts import element_apply, peaks
from harness import spans


class Ev:
    """An event as a torch without `activity_type()` on its events gives it."""

    def __init__(self, name, start, dur, kind="user_annotation", corr=0, tid=1):
        self._n, self._s, self._d, self._k, self._c, self._t = name, start, dur, kind, corr, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._k in ("kernel", "gpu_memcpy") else DeviceType.CPU

    def is_user_annotation(self):
        return self._k == "user_annotation"

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


class KindEv(Ev):
    """The same event from a torch whose events carry their kind."""

    def activity_type(self):
        return self._k


@pytest.mark.parametrize("Ev", [Ev, KindEv])
def test_read_attributes_by_correlation_across_threads(Ev):
    evs = [
        Ev("portbench.cycle", 0, 1000),
        Ev("portbench.step", 100, 800),
        Ev("diffsound.step", 110, 780),
        Ev("diffsound.backward", 300, 300),  # the main thread waits in here
        Ev("cudaLaunchKernel", 50, 5, kind="cuda_runtime", corr=9),
        Ev("cudaLaunchKernel", 150, 5, kind="cuda_runtime", corr=5),
        Ev("cudaLaunchKernel", 350, 5, kind="cuda_runtime", corr=7, tid=2),  # autograd thread
        Ev("cudaMemcpyAsync", 700, 5, kind="cuda_runtime", corr=8),
        Ev("aten::mm", 320, 20, kind="cpu_op", corr=5),  # an op's id, not a runtime call's
        Ev("k_before", 60, 20, kind="kernel", corr=9),
        Ev("k_step", 200, 60, kind="kernel", corr=5),
        Ev("k_backward", 400, 100, kind="kernel", corr=7),  # runs after its launch
        Ev("copy", 1200, 50, kind="gpu_memcpy", corr=8),  # after the cycle
    ]
    r = spans.read(evs, {"lobpcg.sweeps": 2})
    s = r["spans"]
    assert r["counters"] == {"lobpcg.sweeps": 2}
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["device_s"] == pytest.approx(180e-9)
    assert s["diffsound.backward"]["device_s"] == pytest.approx(100e-9)
    assert s["diffsound.step"]["device_s"] == pytest.approx(60e-9)
    assert s["portbench.cycle"]["device_s"] == pytest.approx(20e-9)
    assert r["attributed_share"] == pytest.approx(100 * 160 / 180)
    assert r["span_device"] == [["diffsound.backward", pytest.approx(100e-9)],
                                ["diffsound.step", pytest.approx(60e-9)]]
    assert s["diffsound.step"]["self_s"] == pytest.approx(480e-9)
    assert s["diffsound.backward"]["self_s"] == pytest.approx(300e-9)
    assert s["portbench.step"]["self_s"] == pytest.approx(20e-9)
    assert (s["diffsound.step"]["launches"], s["diffsound.backward"]["launches"],
            s["portbench.cycle"]["launches"]) == (1, 1, 1)
    assert s["diffsound.step"]["launches_in"] == 2 and s["portbench.cycle"]["launches_in"] == 3
    # busy [60, 80], [200, 260], [400, 500]; gaps by their midpoints 30, 140, 330, 750
    idle = dict(r["idle_spans"])
    assert idle == pytest.approx({"portbench.cycle": 60e-9, "diffsound.step": 620e-9,
                                  "diffsound.backward": 140e-9})
    assert sum(v["calls"] for v in s.values()) == 4


def test_read_without_the_cycle_span_reads_nothing():
    assert spans.read([Ev("diffsound.step", 0, 10)], {}) == {}


def _sp(counters, rows):
    zero = dict.fromkeys(("calls", "wall_s", "self_s", "device_s", "launches", "launches_in",
                          "idle_s"), 0)
    return {"spans": {name: dict(zero, **r) for name, r in rows.items()}, "counters": counters}


def test_readings():
    dims = {"E": 13182, "nodes": 10, "V": 19683}
    c = {"fem.k_apply.calls": 3, "fem.k_apply.cols": 3 * 700, "fem.m_apply.calls": 2,
         "fem.m_apply.cols": 2 * 352, "lobpcg.sweeps": 3, "lobpcg.pair_sweeps": 48,
         "lobpcg.pair_sweeps_active": 12}
    sp = _sp(c, {"diffsound.fem.k_apply": {"device_s": 4e-3},
                 "diffsound.fem.m_apply": {"device_s": 1e-3},
                 "diffsound.lobpcg.eigh": {"wall_s": 60e-3, "device_s": 6e-3, "calls": 4},
                 "diffsound.lobpcg.sweep": {"launches_in": 1500, "launches": 30}})
    bound = 3 * peaks.bound_s(*element_apply.count(13182, 10, 700, 19683)) + \
        2 * peaks.bound_s(*element_apply.mass_count(13182, 10, 352, 19683))
    r = spans.readings(sp, dims)
    assert r["apply_roofline"] == pytest.approx(100 * bound / 5e-3)
    assert r["eigh_ms"] == pytest.approx(2.0)  # device time, not the wall
    assert r["sweep_launches"] == pytest.approx(500.0)
    assert set(r) == {"apply_roofline", "eigh_ms", "sweep_launches"}


@pytest.mark.parametrize("sp", [None, {}, {"spans": {}, "counters": {}}])
def test_readings_of_a_cycle_without_the_program_spans_are_none(sp):
    assert set(spans.readings(sp, {}).values()) == {None}


def test_read_takes_the_program_prefix():
    evs = [Ev("portbench.cycle", 0, 100), Ev("toy.step", 10, 50),
           Ev("cudaLaunchKernel", 20, 5, kind="cuda_runtime", corr=3),
           Ev("k", 30, 10, kind="kernel", corr=3)]
    r = spans.read(evs, {}, prefix="toy.")
    assert r["span_device"] == [["toy.step", pytest.approx(10e-9)]]
    assert r["attributed_share"] == pytest.approx(100.0)
    assert spans.read(evs, {})["span_device"] == []


def test_a_program_without_tracing_gives_none(monkeypatch):
    from harness import main

    monkeypatch.setitem(sys.modules, "diffsound_torch.utils.profiler",
                        types.ModuleType("diffsound_torch.utils.profiler"))
    assert main.driver({}).program_tracing() is None
    assert spans.program_cycle(object(), None) is None


def test_program_cycle_on_the_cpu(in_tmp_cwd):
    import torch

    from harness import main as harness

    spec = tiny_spec(cells=3, pairs=4)
    drv = harness.driver(spec["cfg"])
    dev = torch.device("cpu")
    inp = drv.make_inputs(spec["cfg"], spec["traffic"], 2**31 + 12345, dev)
    prog = drv.Program(spec["cfg"], inp, dev)
    prog.setup_steps()
    sp = spans.program_cycle(prog, drv.program_tracing())
    its = prog.refresh_iters[-1]
    c, s = sp["counters"], sp["spans"]
    assert c["lobpcg.sweeps"] == max(its) == s["diffsound.lobpcg.sweep"]["calls"]
    assert c["lobpcg.pair_sweeps_active"] == sum(its)
    assert c["lobpcg.pair_sweeps"] == len(its) * max(its)
    assert s["diffsound.step"]["calls"] == prog.cycle_len
    assert s["portbench.step"]["calls"] == prog.cycle_len - 1
    assert s["diffsound.lobpcg.eigh"]["calls"] >= max(its)
    r = spans.readings(sp, drv.dims(spec["cfg"], inp))
    # no device time on the CPU, so neither device reading
    assert r["eigh_ms"] is None and r["apply_roofline"] is None
