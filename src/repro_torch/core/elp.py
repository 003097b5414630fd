"""EPS / ELP accounting (paper Definitions 1 and 2), the port's copy of the
parts of ``repro/core/elp.py`` its runners need: ``elp``, the sliding-window
``EPSMeter``, ``median_eps`` and the per-slot busy-clock ``SlotEPS``.
Host-only."""
from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, Tuple


def elp(batch_size: int, n_hogwild: int, n_replicas: int) -> int:
    """Examples processed concurrently at any instant. Two-level data
    parallelism: Hogwild within a trainer x replication across."""
    return batch_size * n_hogwild * n_replicas


@dataclass
class EPSMeter:
    """Examples Per Second over a true sliding window.

    ``add(n)`` records a bucket of ``n`` examples at the current clock time;
    ``eps`` is the rate over the trailing ``window_s`` seconds (buckets older
    than the window are evicted). Before a full window has elapsed the rate
    is over the time since construction, so early readings are not inflated.
    This matters for elasticity measurements: after a trainer crashes, the
    windowed rate converges to the SURVIVORS' pace instead of being diluted
    forever by the dead trainer's early contribution (a cumulative
    examples-since-construction rate — the previous implementation — never
    recovers). ``clock`` is injectable for deterministic tests AND for
    running the meter on a virtual clock: ``SlotEPS`` below feeds each
    per-trainer meter that trainer's accumulated BUSY time, so the reading
    is the trainer's intrinsic pace even while it blocks at a foreground
    sync barrier.

    Concurrency: one writer (``add``, which evicts) + any readers (``eps``
    never mutates — it snapshots the deque and filters, so a reader racing a
    writer cannot mis-evict a live bucket).
    """

    window_s: float = 5.0
    clock: Callable[[], float] = time.perf_counter
    _t0: float = field(init=False)
    _buckets: Deque[Tuple[float, int]] = field(init=False)

    def __post_init__(self) -> None:
        self._t0 = self.clock()
        self._buckets = deque()  # hogwild-race: ok — single writer, readers snapshot

    def _evict(self, now: float) -> None:
        # strictly-older-than-window: a bucket exactly at the cutoff is kept
        cutoff = now - self.window_s
        while self._buckets and self._buckets[0][0] < cutoff:
            self._buckets.popleft()

    def add(self, n: int) -> None:
        now = self.clock()
        self._buckets.append((now, n))
        self._evict(now)

    @property
    def eps(self) -> float:
        now = self.clock()
        span = min(now - self._t0, self.window_s)
        if span <= 0:
            return 0.0
        cutoff = now - self.window_s
        # list(deque) is atomic under the GIL; filtering instead of evicting
        # keeps this read-only (safe against a concurrent add)
        return sum(n for t, n in list(self._buckets) if t >= cutoff) / span


def median_eps(values: Iterable[float]) -> float:
    """Median of a (possibly empty) collection of rates; empty -> 0.0."""
    vals = list(values)
    return float(statistics.median(vals)) if vals else 0.0


class SlotEPS:
    """A bank of per-slot ``EPSMeter``s — the straggler controller's signal
    source (``core/scheduler.py`` reads ``eps_by_slot`` and takes its own
    ``median_eps`` over the slots it considers comparable).

    Each slot's meter runs on that slot's own virtual clock — ``tick(slot,
    busy_s)`` advances it by the seconds the trainer actually spent working
    (compute + any injected degradation), ``add(slot, n)`` then records the
    examples at that clock. Excluding time blocked at a foreground sync
    barrier is the point: under ``mode="fixed_rate"`` the barrier equalizes
    everyone's WALL-clock rate (the healthy trainers wait for the straggler),
    so a wall-time meter cannot tell who the straggler is. Busy-time can.

    Thread model: slot ``i`` is written only by trainer thread ``i``; the
    controller only reads (``eps`` is non-mutating), so no lock is needed.
    """

    def __init__(self, n_slots: int, window_s: float = 5.0):
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.window_s = float(window_s)
        self._busy = [0.0] * self.n_slots  # hogwild-race: ok — slot-owned cells
        # hogwild-race: ok — slot-owned meters: only owner slot i mutates _meters[i]
        self._meters = [
            EPSMeter(window_s=window_s, clock=self._make_clock(i)) for i in range(self.n_slots)
        ]

    def _make_clock(self, slot: int) -> Callable[[], float]:
        return lambda: self._busy[slot]

    def tick(self, slot: int, busy_s: float) -> None:
        """Advance slot's virtual clock by ``busy_s`` seconds of real work."""
        self._busy[slot] += busy_s

    def add(self, slot: int, n: int) -> None:
        self._meters[slot].add(n)

    def busy(self, slot: int) -> float:
        return self._busy[slot]

    def eps(self, slot: int) -> float:
        return self._meters[slot].eps

    def eps_by_slot(self) -> Dict[int, float]:
        return {i: self._meters[i].eps for i in range(self.n_slots)}
