"""Pair-iterations a second: every pair's steps in the window over the
window's time, from its start to a synchronise after its last cycle."""


def read(ctx):
    w = ctx["window"]
    return w["pair_iters"] / w["wall_s"]
