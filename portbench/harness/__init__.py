"""The benchmark harness of diffsound_torch (see portbench/run.py)."""
