"""Shared pieces of the benchmark's own tests (run from the repository
root: python -m pytest portbench/tests -q)."""

import os
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
sys.path[:0] = [PORTBENCH, ROOT]


def tiny_spec(cells: int = 4, pairs: int = 4, cell: str = "sync_ord2.pairs16") -> dict:
    """`cell` of the repository's BENCHMARK.json at a CPU-sized mesh."""
    from harness import main

    spec = main.cell_spec(ROOT, cell)
    spec["cfg"]["mesh"] = dict(spec["cfg"]["mesh"], cells=cells)
    spec["cfg"]["frame_num"] = 2000
    spec["traffic"] = dict(spec["traffic"], pairs=pairs)
    return spec


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def in_tmp_cwd(tmp_path, monkeypatch):
    """Run in a fresh directory, so the input cache lands there."""
    monkeypatch.chdir(tmp_path)
    return tmp_path
