"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the measured program.  Each check runs in a fresh
interpreter and compares top-level module names whole."""

import json
import subprocess
import sys

from conftest import PORTBENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "diffsound_tpu"}


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{PORTBENCH!r}, {ROOT!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_set_up_and_steps_load_no_jax(tmp_path):
    mods = loaded_after(f"""
import os, time, torch
torch.set_num_threads(2)
os.chdir({str(tmp_path)!r})
sys.path.insert(0, {PORTBENCH + '/tests'!r})
from conftest import tiny_spec
from harness import main, check
spec = tiny_spec(cells=2, pairs=4)
m = main.measure(spec, 2**31 + 7, 0.0, False, "cpu", time.perf_counter())
check.numbers(m["rec"], m["inputs"], spec["cfg"], torch.device("cpu"))
import run, calibrate
""")
    assert "diffsound_torch" in mods  # the set-up did drive the program
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after("""
import numpy as np, torch
from reference import fem, mesh, model
v, t = mesh.make_mesh({"kind": "cube", "cells": 1, "size": 0.3}, 2)
el = fem.elements(v, t, 2)
model.forms(el, torch.randn(3 * v.shape[0], 3, dtype=torch.float64))
""")
    assert "diffsound_torch" not in mods
    assert not mods & FORBIDDEN


def test_run_without_a_card_prints_no_result(tmp_path):
    import shutil

    # a checkout of only BENCHMARK.json and the benchmark's directory
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sync_ord2.pairs16",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
