"""Milliseconds a plain step: the window's spans over the steps of each
cycle after the one that recomputes the forms (14 of 15), synced at both
ends, over their count."""


def read(ctx):
    spans = ctx["window"].get("spans")
    if not spans or not spans["steps_s"]:
        return None
    return 1e3 * sum(spans["steps_s"]) / (ctx["plain_steps"] * len(spans["steps_s"]))
