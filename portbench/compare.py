"""The numbers that decide ``correct``: what the timed path produced, against
the plain reference on the same inputs. Each is held to the limit that its
cell's ``portbench/limits/<cell>.json`` sets from measured readings."""

from __future__ import annotations

import statistics

import torch


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``||got - ref|| / ||ref||`` over the rows (clips) of
    ``[rows, n]`` tensors."""
    got, ref = got.double(), ref.double()
    num = torch.linalg.vector_norm(got - ref, dim=-1)
    den = torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def loss_rel_gap(got: list, ref: list) -> float:
    """The largest ``|loss - ref| / |ref|`` over the steps."""
    return max(abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got, ref))


def leaf_norm_gap(got: dict, ref: dict, keep: set) -> float:
    """The worst leaf's ``| ||got|| - ||ref|| |`` over the larger of that
    leaf's reference norm and the median leaf's, over the leaves in
    ``keep``."""
    norms = {k: (float(torch.linalg.vector_norm(got[k].double())), float(torch.linalg.vector_norm(ref[k].double())))
             for k in keep}
    med = statistics.median(r for _, r in norms.values())
    return max(abs(g - r) / max(r, med, 1e-30) for g, r in norms.values())


def moving_leaves(ref_grads: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient norm is at least ``share`` of
    the median leaf's. The others (nought to rounding) move under Adam by
    round-off alone and are left out of the gradient and change checks."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= share * med}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """Every number that ``limits`` names against its limit: ``(all within,
    {name: {"value", "limit"}})``. A named number that the run did not give,
    or that is not a number, fails; numbers the limits do not name are not
    compared."""
    out, ok = {}, bool(limits)
    for name, spec in limits.items():
        value = values.get(name, float("nan"))
        ok = ok and value == value and value <= spec["limit"]
        out[name] = {"value": value, "limit": spec["limit"]}
    return ok, out
