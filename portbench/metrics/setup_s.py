"""Seconds from the process' start to the window's: imports, inputs,
building the trainer and the kernels, the recipe's first 15 steps and one
warm-up cycle."""


def read(ctx):
    return ctx["setup_s"]
