"""Milliseconds a refresh: the window's spans around each batched refresh,
synced on both sides as the recipe's loop does, over their count."""


def read(ctx):
    spans = ctx["window"].get("spans")
    if not spans or not spans["refresh_s"]:
        return None
    return 1e3 * sum(spans["refresh_s"]) / len(spans["refresh_s"])
