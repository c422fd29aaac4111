"""Share of its roofline of the synthesis backward kernel: the bound of
`counts/synth_bwd.py` at the cell's (pairs, modes, samples) over the
kernel's device time a call, by name from the traced cycle."""

from counts import peaks, synth_bwd
from harness.trace import kernel_time


def read(ctx):
    sec, calls = kernel_time(ctx.get("trace") or {}, "synth_bwd")
    if not calls:
        return None
    d = ctx["dims"]
    return 100.0 * peaks.bound_s(*synth_bwd.count(d["B"], d["M"], d["T"])) / (sec / calls)
