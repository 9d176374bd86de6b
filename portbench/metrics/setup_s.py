"""Seconds from the process's start to the end of warm-up: imports, the
kernel build (cached in the checkout after a cell's first run), weights,
model construction and one warm-up pass of the cell's shapes (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
