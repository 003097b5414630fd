"""Tuning-free sync <-> async mode switching from live cohort dispersion.
The port's own copy of ``repro/core/modeswitch.py`` (host-only).

The straggler policy (``core/scheduler.py``) closes the membership loop;
this module closes the mode loop: switch the WHOLE cohort's training mode
at runtime from observed heterogeneity (GBA, PAPERS.md). A homogeneous
cohort gets ``fixed_rate`` (foreground barrier, best trajectory quality); a
skewed one gets ``shadow`` (background sync, best throughput, nobody drags
anybody).

``ModeController`` is a deterministic two-state machine over dispersion
observations (DESIGN.md §14):

    fixed_rate --dispersion >= skew_high persists window_s--> shadow
    shadow     --dispersion <= skew_low  persists window_s--> fixed_rate

* Dispersion: ``max(max/median, median/min)`` busy-EPS over the live slots
  with signal, so one slow and one fast outlier both register; 1.0 is a
  perfectly homogeneous cohort.
* Hysteresis: ``skew_high > skew_low``, so a cohort between the bands parks
  in its current mode; a breach must persist a full ``window_s`` (two
  observations minimum).
* Min-dwell: after any switch the controller holds the new mode for
  ``min_dwell_s`` whatever the signal, since a switch costs a barrier drain
  or a catch-up sync.
* Quality: the caller may fold in a ``quality_skew`` (per-slot loss-EMA
  divergence against the cohort median); the controller judges the max of
  pace and quality skew.

Runtime-agnostic like ``StragglerPolicy``: ``ThreadedShadowRunner`` feeds it
real busy-EPS dispersion each shadow round (wall-clock domain);
``ControllerModeSchedule`` adapts it into a deterministic per-iteration
mode trace for ``HogwildSim`` (iteration-clock domain). ``observe`` is
lock-guarded: the shadow thread and the supervisor's backup tick may both
evaluate it, and a transition must never fire twice against one window.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.elp import median_eps

MODES = ("shadow", "fixed_rate")


@dataclass(frozen=True)
class ModeConfig:
    """Tuning knobs for ``ModeController`` (defaults favor stability;
    benchmarks/elastic_bench.py uses a snappier profile)."""

    skew_high: float = 2.0    # fixed_rate -> shadow above this dispersion
    skew_low: float = 1.3     # shadow -> fixed_rate at/below this
    window_s: float = 1.0     # breach must persist this long to switch
    min_dwell_s: float = 2.0  # hold a freshly entered mode at least this long
    start_mode: str = "fixed_rate"

    def validate(self) -> "ModeConfig":
        if self.start_mode not in MODES:
            raise ValueError(f"start_mode must be one of {MODES}, got {self.start_mode!r}")
        if not self.skew_low >= 1.0:
            raise ValueError(
                f"skew_low must be >= 1.0 (dispersion of a homogeneous "
                f"cohort), got {self.skew_low}")
        if self.skew_high <= self.skew_low:
            raise ValueError(
                f"skew_high ({self.skew_high}) must be > skew_low "
                f"({self.skew_low}) — the hysteresis band is what stops a "
                f"borderline cohort from flapping between modes")
        if self.window_s <= 0 or self.min_dwell_s < 0:
            raise ValueError(
                f"need window_s > 0 and min_dwell_s >= 0, got "
                f"window_s={self.window_s}, min_dwell_s={self.min_dwell_s}")
        return self


@dataclass(frozen=True)
class ModeDecision:
    """One controller decision, with provenance for the membership log."""

    target: str  # the mode to enter
    reason: str


class ModeController:
    """Dispersion-driven mode controller. Feed it skew observations via
    ``observe``; it returns the mode switch to apply (or None).

    Deterministic: decisions depend only on the observation sequence (no
    internal clocks — ``now`` is caller-supplied, wall seconds in the
    threaded runner, the iteration counter in ``ControllerModeSchedule``).
    """

    def __init__(self, config: Optional[ModeConfig] = None):
        self.config = (config or ModeConfig()).validate()
        # guarded-by-writes: _lock — moves under _lock on a switch decision;
        # lock-free reads (the trainers' per-iteration mode check) see a
        # coherent latest mode
        self._mode = self.config.start_mode
        self._mode_since: Optional[float] = None  # guarded-by: _lock
        self._breach_since: Optional[float] = None  # guarded-by: _lock
        # (now, from_mode, to_mode, reason) — observability + tests
        self.transitions: List[Tuple[float, str, str, str]] = []  # guarded-by-writes: _lock
        # observe() may be called from two threads (the shadow round AND the
        # supervisor's backup tick while the shadow thread is restarting)
        self._lock = threading.Lock()

    @property
    def mode(self) -> str:
        return self._mode

    @staticmethod
    def dispersion(
        eps_by_slot: Mapping[int, float],
        active: Sequence[bool],
        eligible: Optional[Sequence[bool]] = None,
    ) -> float:
        """Cohort pace spread: ``max(max/median, median/min)`` busy-EPS over
        the live slots with signal. Returns 0.0 (no signal — never act
        blind) with fewer than two measurable slots."""
        n = len(active)
        if eligible is None:
            eligible = [True] * n
        vals = [
            float(eps_by_slot.get(i, 0.0))
            for i in range(n)
            if active[i] and eligible[i] and eps_by_slot.get(i, 0.0) > 0.0
        ]
        if len(vals) < 2:
            return 0.0
        med = median_eps(vals)
        if med <= 0.0:
            return 0.0
        return max(max(vals) / med, med / min(vals))

    def observe(
        self, now: float, dispersion: float, quality_skew: float = 0.0
    ) -> Optional[ModeDecision]:
        """One controller round over the current skew reading. Returns the
        switch to apply, or None. The caller applies the handoff (barrier
        drain / catch-up sync) — the controller only decides."""
        with self._lock:
            return self._observe_locked(now, float(dispersion), float(quality_skew))

    # holds-lock: _lock
    def _observe_locked(
        self, now: float, dispersion: float, quality_skew: float
    ) -> Optional[ModeDecision]:
        cfg = self.config
        if self._mode_since is None:
            self._mode_since = now  # dwell clock starts at first observation
        if dispersion <= 0.0:
            self._breach_since = None
            return None  # no signal yet (startup) — never act blind
        skew = max(dispersion, quality_skew)
        if self._mode == "fixed_rate":
            breach, target = skew >= cfg.skew_high, "shadow"
            why = (f"dispersion {skew:.2f} >= skew_high {cfg.skew_high:g} "
                   f"for {cfg.window_s:g}s: cohort skewed, barrier would "
                   f"drag everyone to the straggler's pace")
        else:
            breach, target = skew <= cfg.skew_low, "fixed_rate"
            why = (f"dispersion {skew:.2f} <= skew_low {cfg.skew_low:g} "
                   f"for {cfg.window_s:g}s: cohort homogeneous, foreground "
                   f"sync buys quality at no throughput cost")
        if not breach:
            # healthy for the current mode, or parked between the bands:
            # either way the breach streak is broken
            self._breach_since = None
            return None
        if self._breach_since is None:
            self._breach_since = now
            return None
        if now - self._breach_since < cfg.window_s:
            return None
        if now - self._mode_since < cfg.min_dwell_s:
            return None  # breach persists but the dwell holds — keep parking
        self.transitions.append((now, self._mode, target, why))
        self._mode = target
        self._mode_since = now
        self._breach_since = None
        return ModeDecision(target, why)


class ModeSchedule:
    """A scripted, deterministic per-iteration mode trace for ``HogwildSim``:
    ``[(iteration, mode), ...]`` switch points, evaluated on the iteration
    clock. Iterations before the first switch point run ``start_mode``."""

    def __init__(
        self,
        events: Sequence[Tuple[int, str]],
        *,
        start_mode: str = "shadow",
    ):
        if start_mode not in MODES:
            raise ValueError(f"start_mode must be one of {MODES}, got {start_mode!r}")
        evs = sorted((int(t), str(m)) for t, m in events)
        for t, m in evs:
            if m not in MODES:
                raise ValueError(f"mode schedule names unknown mode {m!r} at iteration {t}")
        self._events = evs
        self.start_mode = start_mode

    def mode_at(self, t: int) -> str:
        mode = self.start_mode
        for tt, m in self._events:
            if tt > t:
                break
            mode = m
        return mode

    def switch_points(self) -> List[Tuple[int, str]]:
        return list(self._events)


class ControllerModeSchedule(ModeSchedule):
    """Adapt a ``ModeController`` into the deterministic mode trace
    ``HogwildSim`` consumes (``mode_at(t)``), so closed-loop mode switching
    is reproducible in the simulator.

    The per-slot rates come from ``rates(t, slot)`` — a scripted trace
    (the sim is deterministic, so "slowness" must be declared, exactly like
    ``StragglerSchedule``). The controller's clock is the iteration
    counter: ``window_s`` / ``min_dwell_s`` are read in iterations here.
    An optional ``quality(t, slot)`` trace feeds the loss-divergence side
    of the decision the same way.

    Modes are evaluated lazily as the sim asks for each iteration and
    cached, so re-reading an earlier iteration replays rather than
    re-evaluating — two runs over the same schedule object (or two fresh
    objects with the same inputs) produce identical trajectories.
    """

    def __init__(
        self,
        controller: ModeController,
        rates: Callable[[int, int], float],
        n_slots: int,
        *,
        quality: Optional[Callable[[int, int], float]] = None,
    ):
        super().__init__([], start_mode=controller.mode)
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.controller = controller
        self.rates = rates
        self.quality = quality
        self.n_slots = int(n_slots)
        self._mode_by_t: Dict[int, str] = {}
        self._next_t = 0

    def mode_at(self, t: int) -> str:
        # evaluate every iteration up to t exactly once (the sim calls with
        # monotonically increasing t; a resumed run skips the gap in one go)
        while self._next_t <= t:
            tt = self._next_t
            self._next_t += 1
            eps = {s: float(self.rates(tt, s)) for s in range(self.n_slots)}
            disp = ModeController.dispersion(eps, [True] * self.n_slots)
            q = 0.0
            if self.quality is not None:
                lv = [float(self.quality(tt, s)) for s in range(self.n_slots)]
                vals = [v for v in lv if v > 0.0]
                if len(vals) >= 2:
                    med = median_eps(vals)
                    if med > 0.0:
                        q = max(vals) / med
            dec = self.controller.observe(float(tt), disp, quality_skew=q)
            if dec is not None:
                self._events.append((tt, dec.target))
            self._mode_by_t[tt] = self.controller.mode
        return self._mode_by_t[t]
