"""Share of the float32 peak: the window's operations, counted by
`counts/step_flops.py` from the shapes and the LOBPCG iterations each pair
reported, over the window's time."""

from counts import peaks, step_flops


def read(ctx):
    w = ctx["window"]
    flops = step_flops.window(ctx["dims"], w["steps"], w["refresh_iters"])
    return 100.0 * flops / (w["wall_s"] * peaks.F32_FLOPS)
