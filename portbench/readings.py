"""Helpers of the metric readers (``portbench/metrics/*.py``): readings of a
traced run's reduction (``trace.reduce``) that are reported only when the
kernel records they rest on match the program's launch counters."""

from __future__ import annotations


def checked(ctx: dict, *groups: str) -> bool:
    """Whether the traced session holds every kernel group in ``groups`` with
    as many records as the counters saw launches."""
    t = ctx.get("trace")
    if t is None:
        return False
    return all(g in t["groups"] and t["groups"][g]["checked"] for g in groups)


def range_per_call(ctx: dict, names, key: str, per: str | None = None):
    """``key`` (``device_s`` or ``records``) summed over the ``pb.`` ranges
    ``names``, per call of the range ``per`` (by default per session)."""
    t = ctx.get("trace")
    if t is None or not all(n in t["ranges"] for n in names):
        return None
    total = sum(t["ranges"][n][key] for n in names)
    calls = t["ranges"][per]["count"] if per is not None else 1
    return total / calls if calls else None


def roofline(ctx: dict, *groups: str):
    """Percent: the summed bound of the groups' launches over their summed
    device time."""
    if not checked(ctx, *groups):
        return None
    g = ctx["trace"]["groups"]
    dev = sum(g[k]["device_s"] for k in groups)
    return 100.0 * sum(g[k]["bound_s"] for k in groups) / dev if dev > 0 else None


def idle_share(ctx: dict):
    """Percent of the traced window in which no device operation ran."""
    t = ctx.get("trace")
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
