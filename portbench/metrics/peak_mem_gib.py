"""GiB: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start."""


def read(ctx):
    b = ctx.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
