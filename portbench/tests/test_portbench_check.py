"""The correctness check on the CPU at a small mesh: a sound run passes
the cell's limits, and each fault planted under the timed path fails them."""

import time

import pytest
import torch

from conftest import tiny_spec


def judged(fault, seed=2**31 + 11):
    from harness import check, main

    spec = tiny_spec()
    drv = main.driver(spec["cfg"])
    torch.set_num_threads(2)
    try:
        m = main.measure(spec, seed, 0.0, False, "cpu", time.perf_counter(), fault)
    finally:
        drv.heal()
    values = drv.numbers(m["rec"], m["inputs"], spec["cfg"], torch.device("cpu"))
    return check.judge(values, spec["limits"], drv.NAMES)


def test_sound_run_is_correct(in_tmp_cwd):
    ok, rows = judged(None)
    assert ok, rows


@pytest.mark.parametrize("fault", ["step_unchanged", "refresh_unchanged", "half_batch",
                                   "signal_altered", "freq_altered", "pair_grad_dropped",
                                   "refresh_skips_mode"])
def test_fault_is_caught(in_tmp_cwd, fault):
    ok, rows = judged(fault)
    assert not ok, rows


def test_limits_must_name_every_number():
    from harness import check

    values = dict.fromkeys(check.NAMES, 0.0)
    limits = dict.fromkeys(check.NAMES[1:], 1.0)
    with pytest.raises(KeyError):
        check.judge(values, limits, check.NAMES)


def test_run_reports_correct_false_under_a_fault(in_tmp_cwd):
    from harness import main

    spec = tiny_spec()
    try:
        out = main.run(spec, 5, 0.0, True, "cpu", time.perf_counter(), "half_batch")
    finally:
        main.driver(spec["cfg"]).heal()
    assert out["correct"] is False
    assert list(out)[-1] == "checks"
    assert out["checks"]["loss"]["value"] > out["checks"]["loss"]["limit"]
