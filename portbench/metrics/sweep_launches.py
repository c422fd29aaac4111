"""Kernel launches a LOBPCG sweep: the launches inside the
`diffsound.lobpcg.sweep` spans of the program-traced cycle over
`lobpcg.sweeps` (harness/spans.py::readings)."""

from harness import spans


def read(ctx):
    return spans.readings(ctx.get("spans"), ctx["dims"])["sweep_launches"]
