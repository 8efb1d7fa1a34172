"""The comparison of a training cell's first steps with the plain
reference: each step's loss, the norm of the first gradient as the
optimizer got it, the first gradient's per-element statistics as the
optimizer holds them after one step (``moment_gap``), and the norm of
each parameter's change over the first steps. Each leaf's gap is the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and the median leaf's (for the
statistics, the norm of their difference over the same); a cell compares
the worst leaf's gap or, where its look showed the worst to be noise, the
leaf at a stated quantile, over every leaf or over the leaves whose name
starts with a stated prefix. A norm alone is blind to rounding that is
unbiased (it adds in quadrature), so the statistics are what a lower
precision fails. A leaf whose reference gradient is under a thousandth
of the median leaf's moves by round-off alone and is left out of the
change and the statistics.

Every number is finite: a missing or non-finite reading becomes
``NOT_FINITE``, which fails any limit."""

from __future__ import annotations

import math
import statistics

from .steps import quantile

NOT_FINITE = 1e30
MOVED_SHARE = 1e-3


def _finite(x: float) -> float:
    x = float(x)
    return x if math.isfinite(x) else NOT_FINITE


def loss_gap(prog_losses, ref_losses, steps=None) -> float:
    """The widest relative gap of the first ``steps`` steps' losses (all
    the captured steps by default)."""
    if len(prog_losses) != len(ref_losses) or not ref_losses:
        return NOT_FINITE
    pairs = list(zip(prog_losses, ref_losses))[:steps]
    return max(_finite(abs(p - r) / max(abs(r), 1e-30)) for p, r in pairs)


def norm_gap(prog: dict, ref: dict, leaves=None, q: float = 1.0):
    """(the gap of the leaf at quantile ``q`` over ``leaves`` (default
    every reference leaf; q = 1: the worst), the worst leaf)."""
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    if not leaves:
        return NOT_FINITE, None
    med = statistics.median(ref[k] for k in leaves)
    gaps = {}
    for k in leaves:
        if k not in prog:
            return NOT_FINITE, k
        gaps[k] = _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return quantile(gaps.values(), q), max(gaps, key=gaps.get)


def vector_gap(prog: dict, ref: dict, leaves):
    """(worst gap, its leaf, every leaf's gap): ``||p - r||`` over the
    larger of ``||r||`` of that leaf and of the median leaf, for
    per-element statistics."""
    leaves = sorted(leaves)
    if not leaves:
        return NOT_FINITE, None, {}
    norms = {k: float(ref[k].double().norm()) for k in leaves}
    med = statistics.median(norms.values())
    gaps = {}
    for k in leaves:
        p = prog.get(k)
        if p is None or p.shape != ref[k].shape:
            return NOT_FINITE, k, {}
        gaps[k] = _finite(float((p.double() - ref[k].double()).norm())
                          / max(norms[k], med, 1e-30))
    where = max(gaps, key=gaps.get)
    return gaps[where], where, gaps


def moved_leaves(ref_grad_norms: dict) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= MOVED_SHARE * med]


def training_numbers(prog: dict, ref: dict, loss_steps=None,
                     quantiles=None, leaves=None) -> dict:
    """``prog`` and ``ref``: ``{"losses": [...], "grad_norms": {leaf:
    norm}, "change_norms": {leaf: norm}}``. ``leaves`` may name, for a
    gap, the prefix of the leaves it reads. Returns the compared numbers
    and, for the report, the leaves that gave the norm gaps."""
    q = {"grad_gap": 1.0, "moment_gap": 1.0, "change_gap": 1.0,
         **(quantiles or {})}
    pre = leaves or {}

    def among(names, gap):
        return [k for k in names if k.startswith(pre.get(gap, ""))]

    grad, grad_leaf = norm_gap(prog.get("grad_norms") or {},
                               ref["grad_norms"],
                               among(ref["grad_norms"], "grad_gap"),
                               q=q["grad_gap"])
    moved = moved_leaves(ref["grad_norms"])
    change, change_leaf = norm_gap(prog.get("change_norms") or {},
                                   ref["change_norms"],
                                   among(moved, "change_gap"),
                                   q=q["change_gap"])
    moment, moment_leaf, moment_gaps = vector_gap(
        prog.get("moments") or {}, ref["moments"],
        among(moved, "moment_gap"))
    if moment_gaps:
        moment = quantile(moment_gaps.values(), q["moment_gap"])
    return {"loss_gap": loss_gap(prog.get("losses") or [], ref["losses"],
                                 loss_steps),
            "grad_gap": grad, "moment_gap": moment, "change_gap": change,
            "_grad_leaf": grad_leaf, "_moment_leaf": moment_leaf,
            "_change_leaf": change_leaf,
            "_left_out": sorted(set(ref["grad_norms"]) - set(moved)),
            "_losses": [list(prog.get("losses") or []), list(ref["losses"])],
            "_moment_by_leaf": moment_gaps,
            "_change_by_leaf": {
                k: [(prog.get("change_norms") or {}).get(k),
                    ref["change_norms"][k]]
                for k in sorted(ref["change_norms"])},
            "_grad_by_leaf": {
                k: [(prog.get("grad_norms") or {}).get(k),
                    ref["grad_norms"][k]]
                for k in sorted(ref["grad_norms"])}}


def checks(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every limit of the cell; a
    number the run did not give fails."""
    return {k: {"value": _finite(numbers.get(k, NOT_FINITE)), "limit": lim}
            for k, lim in limits.items()}


def passed(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
