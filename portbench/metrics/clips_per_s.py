"""Clips completed in the window over the window's length (host clock):
the window starts after warm-up and ends at the first batch that returns
after ``--seconds``, so it holds whole batches."""


def read(ctx):
    if "clips" not in ctx or ctx["window_s"] <= 0:
        return None
    return ctx["clips"] / ctx["window_s"]
