"""LOBPCG iterations a pair takes in a refresh: the trainer's
`last_refresh_iters`, averaged over every pair and refresh of the window."""


def read(ctx):
    its = [i for r in ctx["window"]["refresh_iters"] for i in r]
    return sum(its) / len(its) if its else None
