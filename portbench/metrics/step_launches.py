"""Kernel launches a plain step (cudaLaunchKernel and cuLaunchKernel calls inside
each of the traced cycle's 14 plain-step spans, from torch.profiler)."""


def read(ctx):
    tr = ctx.get("trace")
    return tr["launches_per_step"] if tr else None
