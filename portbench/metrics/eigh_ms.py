"""Device milliseconds of the float64 `eigh`s a LOBPCG sweep: the device
seconds of the kernels and copies launched inside the
`diffsound.lobpcg.eigh` spans of the program-traced cycle over
`lobpcg.sweeps` (harness/spans.py::readings).  None without a card."""

from harness import spans


def read(ctx):
    return spans.readings(ctx.get("spans"), ctx["dims"])["eigh_ms"]
