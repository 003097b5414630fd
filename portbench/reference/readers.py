"""Arithmetic shared by the metric readers (``portbench/metrics/``): each
reader takes the run's record and returns a number, or None where the
record holds nothing for it to read."""
from __future__ import annotations

import statistics
from typing import Iterable, Optional

from . import peaks


def kernel_s(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Device seconds of the traced window's launches whose name holds one
    of ``names``; None without a trace or without such a launch."""
    summ = rec.get("trace")
    if not summ:
        return None
    names = tuple(names)
    found = [t for n, (t, _) in summ["kernels"].items() if any(k in n for k in names)]
    return sum(found) if found else None


def roofline_pct(rec: dict, kernel: str, names: Iterable[str],
                 flops_per_s: float) -> Optional[float]:
    """The kernel's share of its roofline over the traced window: the least
    time its bytes and operations allow (``peaks.bound_s``) over its device
    time."""
    t = kernel_s(rec, names)
    w = rec.get("work", {}).get(kernel)
    if t is None or not w:
        return None
    return 100.0 * peaks.bound_s(w["bytes"], w["flops"], flops_per_s) / t


def idle_pct(rec: dict) -> Optional[float]:
    summ = rec.get("trace")
    if not summ:
        return None
    return 100.0 * (1.0 - summ["busy_s"] / summ["window_s"])


def mfu_pct(rec: dict, flops_per_s: float) -> Optional[float]:
    """Model FLOPs of every step of the timed window over its whole time."""
    if not rec.get("window_s"):
        return None
    return 100.0 * rec["flops_per_iter"] * rec["iters"] / rec["window_s"] / flops_per_s


def p95(xs) -> float:
    return statistics.quantiles(xs, n=20, method="inclusive")[18]
