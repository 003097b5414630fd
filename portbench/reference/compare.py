"""The comparison that decides ``correct``: the numbers a training cell
compares with its plain reference, each against a limit of its own.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: by the worst leaf, the gap between the program's norm of
  the first gradient (as its optimizer holds it after one step) and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf.
- ``change_gap``: the same for the norm of each leaf's change after the
  checked steps. Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone and are left out.

A NaN reads as failed: a number passes only where ``value <= limit``.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's first-gradient norm


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.nan for p, r in zip(prog, ref)]
    return max(gaps, key=lambda g: math.inf if math.isnan(g) else g)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap, its name) over the leaves in ``keep`` (all of
    ``ref``'s by default); a leaf missing or not finite in ``prog`` reads
    NaN."""
    names = sorted(ref if keep is None else keep)
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        p = prog.get(n, math.nan)
        g = abs(p - ref[n]) / max(ref[n], med) if math.isfinite(p) else math.nan
        if math.isnan(g) or g > worst:
            worst, at = g, n
            if math.isnan(g):
                break
    return worst, at


def moved_leaves(ref_grad: Dict[str, float], names: Iterable[str],
                 grad_of=lambda n: n) -> list:
    """The change leaves whose gradient leaf (``grad_of(name)``, or none:
    kept) is not negligible in the reference."""
    med = statistics.median(ref_grad.values())
    return [n for n in names if grad_of(n) not in ref_grad
            or ref_grad[grad_of(n)] >= NEGLIGIBLE_GRAD * med]


def readings(prog: dict, ref: dict, grad_of=lambda n: n) -> Dict[str, Tuple[float, str]]:
    """{name: (value, where)} for the three numbers, in order. ``prog`` and
    ``ref``: {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    keep = moved_leaves(ref["grad"], ref["change"], grad_of)
    return {"loss_gap": (loss_gap(prog["losses"], ref["losses"]), "losses"),
            "grad_gap": worst_leaf(prog["grad"], ref["grad"]),
            "change_gap": worst_leaf(prog["change"], ref["change"], keep)}


def checks(prog: dict, ref: dict, limits: Dict[str, float],
           grad_of=lambda n: n) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for the three numbers, in order."""
    return {k: {"value": v, "limit": limits[k]}
            for k, (v, _) in readings(prog, ref, grad_of).items()}


def passed(checked: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())


def where(prog: dict, ref: dict, grad_of=lambda n: n) -> Dict[str, str]:
    """Where each number reads its value: the worst leaf, with the program's
    and the reference's norms."""
    out = {}
    for k, (v, at) in readings(prog, ref, grad_of).items():
        kind = {"grad_gap": "grad", "change_gap": "change"}.get(k)
        out[k] = at if kind is None else f"{at} {prog[kind].get(at)!r} {ref[kind].get(at)!r}"
    return out
