"""Milliseconds a LOBPCG sweep of the batched refresh: the window's synced
refresh spans over the sweeps they ran, a sweep being one iteration of the
batch, which runs until its slowest pair stops.  How many sweeps a refresh
takes swings from run to run (the step's float32 sums on the card do not
repeat bit for bit unless torch's deterministic algorithms are switched
on, and the exit test at tol 1e-3 reads them); the time a sweep takes
does not, so this reads a change to the refresh's kernels steadily where
`refresh_ms` and the rate read it through that swing."""


def read(ctx):
    spans = ctx["window"].get("spans")
    sweeps = sum(max(r) for r in ctx["window"]["refresh_iters"] if r)
    if not spans or not spans["refresh_s"] or not sweeps:
        return None
    return 1e3 * sum(spans["refresh_s"]) / sweeps
