"""Share of the traced cycle in which no kernel, copy or set ran on the
device: 1 - the union of device activity over the cycle's span."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
