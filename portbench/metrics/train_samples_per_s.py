"""Samples of every training step in the window over the window's length
(host clock, after a synchronise): the window holds whole steps."""


def read(ctx):
    if "samples" not in ctx or ctx["window_s"] <= 0:
        return None
    return ctx["samples"] / ctx["window_s"]
