"""Drivers: every cell of BENCHMARK.json resolves to one by its
configuration file, a configuration that names a driver of its own runs
through the harness with nothing under portbench/harness/ changed, and a
traced run hands the program's spans to the metric files."""

import hashlib
import json
import os
import time

import pytest
import torch

from conftest import PORTBENCH, ROOT, tiny_spec
from harness import main, spans

SPAN_METRICS = ("apply_roofline", "eigh_ms", "sweep_launches")  # spans.readings
REFRESH_METRICS = SPAN_METRICS + ("refresh_active_share",)

# A driver of a configuration the harness does not know: multipair_l1's
# program with every loss doubled, judged by numbers of its own.
TOY = '''
from harness import main

base = main.driver({})
TRAFFIC_KEYS = base.TRAFFIC_KEYS
make_inputs, dims = base.make_inputs, base.dims
FAULTS, plant, heal = base.FAULTS, base.plant, base.heal
program_tracing = base.program_tracing
NAMES = ("doubled_loss", "first_freq")


class Program(base.Program):
    def step(self):
        super().step()
        self.losses[-1] = 2.0 * self.losses[-1]
        return self.losses[-1]


def numbers(rec, inputs, cfg, device, unpinned=False):
    v = base.numbers(rec, inputs, cfg, device, unpinned)
    return {"doubled_loss": abs(v["loss"] - 1.0), "first_freq": v["freq"]}
'''

# The same, reading no traffic note.
STRICT = '''
from harness import main

base = main.driver({})
TRAFFIC_KEYS = set(base.TRAFFIC_KEYS) - {"note"}
'''


def _digest(top: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture
def toy_drivers(tmp_path, monkeypatch):
    """A directory holding the toy drivers, searched after portbench/drivers/."""
    d = tmp_path / "drivers"
    d.mkdir()
    (d / "toy.py").write_text(TOY)
    (d / "toy_strict.py").write_text(STRICT)
    monkeypatch.setattr(main, "DRIVER_DIRS", main.DRIVER_DIRS + (str(d),))
    return d


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_every_cell_resolves_to_multipair_l1(cell):
    spec = main.cell_spec(ROOT, cell)
    assert "driver" not in spec["cfg"]
    drv = main.driver(spec["cfg"])
    assert drv.__file__ == os.path.join(PORTBENCH, "drivers", "multipair_l1.py")
    assert set(drv.NAMES) == set(spec["limits"])


def test_unknown_driver_names_the_path():
    with pytest.raises(FileNotFoundError) as e:
        main.driver({"driver": "no_such_driver"})
    assert os.path.join(PORTBENCH, "drivers", "no_such_driver.py") in str(e.value)


def _root_with(tmp_path, driver: str) -> str:
    """A checkout root whose BENCHMARK.json points sync_ord2.pairs16's
    configuration at a copy that names `driver`."""
    root = tmp_path / "root"
    root.mkdir(parents=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    conf = next(c for c in bench["configs"] if c["name"] == "material_sync.ord2")
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    (root / "toy.json").write_text(json.dumps(dict(cfg, driver=driver)))
    conf["file"] = "toy.json"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_traffic_key_the_driver_does_not_read_is_refused(tmp_path, toy_drivers):
    assert main.cell_spec(_root_with(tmp_path, "toy"), "sync_ord2.pairs16")["cfg"]["driver"] == "toy"
    with pytest.raises(ValueError, match="'note'"):
        main.cell_spec(_root_with(tmp_path / "strict", "toy_strict"), "sync_ord2.pairs16")


def test_toy_driver_runs_end_to_end(in_tmp_cwd, toy_drivers):
    before = _digest(os.path.join(PORTBENCH, "harness"))
    spec = tiny_spec(cells=3, pairs=4)
    spec["cfg"]["driver"] = "toy"
    spec["limits"] = {"doubled_loss": 1e-3, "first_freq": 1.5e-4}
    torch.set_num_threads(2)
    out = main.run(spec, 2**31 + 77, 0.0, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert list(out["checks"]) == ["doubled_loss", "first_freq"]
    assert out["metrics"] and out["failed"] == 0
    assert {"span_device", "idle_spans"} <= set(out["breakdown"])
    assert _digest(os.path.join(PORTBENCH, "harness")) == before


def test_traced_run_hands_the_program_spans_to_the_metrics(in_tmp_cwd):
    spec = tiny_spec(cells=3, pairs=4)
    torch.set_num_threads(2)
    ctx = main.measure(spec, 2**31 + 78, 0.0, True, "cpu", time.perf_counter())["ctx"]
    assert ctx["spans"]["counters"]["lobpcg.sweeps"] > 0
    want = spans.readings(ctx["spans"], ctx["dims"])
    got = {n: main.read_metric(n, ctx) for n in REFRESH_METRICS}
    assert {n: got[n] for n in want} == want
    # no device time and no kernel launches on the CPU
    assert got["apply_roofline"] is None and got["eigh_ms"] is None
    assert got["sweep_launches"] == 0
    its = ctx["window"]["refresh_iters"]
    assert len(its) >= 1 and ctx["spans"]["counters"]["lobpcg.pair_sweeps"] > 0
    assert got["refresh_active_share"] == pytest.approx(
        100 * sum(map(sum, its)) / sum(len(r) * max(r) for r in its))


@pytest.mark.parametrize("its, share", [([[4, 2, 2, 4]], 75.0), ([[4, 2], [1, 1, 1, 5]], 50.0),
                                        ([], None), ([[]], None)])
def test_refresh_active_share_reads_every_refresh_of_the_window(its, share):
    got = main.read_metric("refresh_active_share", {"window": {"refresh_iters": its}})
    assert got == (None if share is None else pytest.approx(share))


def test_without_tracing_the_spans_and_metrics_are_none(in_tmp_cwd, monkeypatch):
    from diffsound_torch.utils import profiler

    spec = tiny_spec(cells=2, pairs=2)
    torch.set_num_threads(2)
    monkeypatch.delattr(profiler, "tracing")
    ctx = main.measure(spec, 2**31 + 79, 0.0, True, "cpu", time.perf_counter())["ctx"]
    assert ctx["spans"] is None
    assert all(main.read_metric(n, ctx) is None for n in SPAN_METRICS)
    assert main.read_metric("refresh_active_share", ctx) > 0  # the window's counter
