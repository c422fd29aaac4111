"""Share of its roofline of the synthesis forward kernel: the bound of
`counts/synth_fwd.py` at the cell's (pairs, modes, samples) over the
kernel's device time a call, by name from the traced cycle."""

from counts import peaks, synth_fwd
from harness.trace import kernel_time


def read(ctx):
    sec, calls = kernel_time(ctx.get("trace") or {}, "synth_fwd")
    if not calls:
        return None
    d = ctx["dims"]
    return 100.0 * peaks.bound_s(*synth_fwd.count(d["B"], d["M"], d["T"])) / (sec / calls)
