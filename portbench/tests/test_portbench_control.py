"""The control on the card: the program with TF32 switched back on for its
float32 products (the precision below the configuration's) must come out
not correct, where the same run in float32 is correct.  At a mesh a test
run holds (cube 5 at order 2, 3,993 DOF, 4 pairs); the cell-size readings
are calibrate.py's."""

import time

import pytest

from conftest import tiny_spec


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_tf32_control_fails_the_check(cuda_device, in_tmp_cwd, tf32):
    from calibrate import set_tf32
    from harness import check, main

    spec = tiny_spec(cells=5, pairs=4)
    spec["cfg"]["frame_num"] = 8000
    try:
        set_tf32(tf32)
        m = main.measure(spec, 2**31 + 3, 0.0, False, cuda_device, time.perf_counter())
    finally:
        set_tf32(False)
    drv = main.driver(spec["cfg"])
    ok, rows = check.judge(drv.numbers(m["rec"], m["inputs"], spec["cfg"], cuda_device),
                           spec["limits"], drv.NAMES)
    assert ok is not tf32, rows
