"""Share of the batched refresh's pair-sweeps spent on a pair still
iterating (%), over every refresh of the window: the pairs' LOBPCG
iterations (the trainer's `last_refresh_iters`) over the pair-sweeps the
batch paid for, each refresh running all its pairs until its slowest
stops (pairs times the most iterations)."""


def read(ctx):
    its = [r for r in ctx["window"]["refresh_iters"] if r]
    paid = sum(len(r) * max(r) for r in its)
    return 100.0 * sum(map(sum, its)) / paid if paid else None
