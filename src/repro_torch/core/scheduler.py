"""Closed-loop straggler scheduling: EPS-driven auto-demotion and
re-admission. The port's own copy of ``repro/core/scheduler.py`` (host-only).

A straggler silently drags quality (its updates go stale) and, in
``fixed_rate`` mode, drags the whole cohort to its pace. This module closes
the detect -> demote -> re-admit loop: the windowed per-slot EPS meters
become a controller that decides who is a member.

``StragglerPolicy`` is a deterministic state machine over per-slot EPS
observations (DESIGN.md §9):

    healthy --breach persists window_s--> suspect --> DEMOTED ("leave")
    demoted --healthy probes persist probation_s--> probation --> re-admitted
                                                                  ("join")

* Demotion: a slot's EPS stays below ``eps_floor_frac`` x the live median
  for a full ``window_s`` (two observations minimum: a single dip is never
  acted on).
* Re-admission: a demoted slot's EPS stays at or above ``readmit_frac`` x
  the live median for a full ``probation_s`` of healthy probe observations.
* Hysteresis: ``readmit_frac > eps_floor_frac``, so a borderline slot parks
  as demoted instead of flapping through the membership log.
* Quorum: the controller never demotes below ``min_active`` live slots, and
  it only re-admits slots IT demoted: crashed slots belong to the fault
  harness, joining slots to their bootstrap.

The policy is runtime-agnostic: ``ThreadedShadowRunner`` feeds it real
busy-time EPS readings (``elp.SlotEPS``) each shadow round (in fixed_rate
from a monitor thread); ``StragglerSchedule`` adapts it into a deterministic
``MembershipSchedule``-compatible event source for ``HogwildSim``, where the
per-slot rates come from a scripted trace.

The supervisor's watch loop (``core/supervision.py``, DESIGN.md §10) also
ticks the policy on the same clock (``time.perf_counter``), so two threads
may call ``observe`` concurrently; the state machine is lock-guarded so a
transition is never evaluated twice against one observation window.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.elp import median_eps
from repro_torch.core.membership import MembershipSchedule

HEALTHY = "healthy"
SUSPECT = "suspect"
DEMOTED = "demoted"
PROBATION = "probation"


@dataclass(frozen=True)
class PolicyConfig:
    """Tuning knobs for ``StragglerPolicy`` (defaults favor stability over
    reaction speed; benchmarks/elastic_bench.py uses a snappier profile)."""

    eps_floor_frac: float = 0.5   # demote below this fraction of live median
    readmit_frac: float = 0.75    # re-admit at/above this fraction (hysteresis)
    window_s: float = 1.0         # breach must persist this long to demote
    probation_s: float = 1.0      # healthy probes must persist this long
    min_active: int = 2           # never demote below this many live slots
    # Quality signals (DESIGN.md §14): pace is not the only
    # way a slot poisons the cohort. ``loss_div_frac`` demotes a slot whose
    # loss EMA stays above (1 + frac) x the cohort median loss for a full
    # window — a diverging trajectory at healthy pace. ``staleness_max``
    # demotes a slot whose last landed sync is older than this (the
    # caller's clock units: wall seconds threaded, iterations in the sim) —
    # its deltas are too stale to merge safely. Both default off; staleness
    # never blocks RE-admission (a demoted slot's age grows by
    # construction — only the pace/loss probes can clear it).
    loss_div_frac: Optional[float] = None
    staleness_max: Optional[float] = None

    def validate(self) -> "PolicyConfig":
        if not 0.0 < self.eps_floor_frac <= 1.0:
            raise ValueError(f"eps_floor_frac must be in (0, 1], " f"got {self.eps_floor_frac}")
        if self.readmit_frac <= self.eps_floor_frac:
            raise ValueError(
                f"readmit_frac ({self.readmit_frac}) must be > "
                f"eps_floor_frac ({self.eps_floor_frac}) — the hysteresis "
                f"band is what stops a borderline slot from flapping")
        if self.window_s <= 0 or self.probation_s < 0:
            raise ValueError(
                f"need window_s > 0 and probation_s >= 0, got "
                f"window_s={self.window_s}, "
                f"probation_s={self.probation_s}"
            )
        if self.min_active < 1:
            raise ValueError(f"min_active must be >= 1, got {self.min_active}")
        if self.loss_div_frac is not None and self.loss_div_frac <= 0:
            raise ValueError(f"loss_div_frac must be > 0, got {self.loss_div_frac}")
        if self.staleness_max is not None and self.staleness_max <= 0:
            raise ValueError(f"staleness_max must be > 0, got {self.staleness_max}")
        return self


@dataclass(frozen=True)
class PolicyAction:
    """One controller decision, with provenance for the membership log."""

    kind: str  # "demote" | "readmit"
    slot: int
    reason: str


@dataclass
class _SlotState:
    state: str = HEALTHY
    since: float = 0.0  # entry time of a timed state (suspect/probation)
    # the live median the slot was judged against when demoted: the
    # re-admission bar when no OTHER eligible slot remains to compare
    # against (health must be proven, never defaulted)
    ref_eps: float = 0.0


class StragglerPolicy:
    """EPS-driven membership controller. Feed it per-slot rate observations
    via ``observe``; it returns the demote/re-admit actions to apply.

    Deterministic: actions depend only on the observation sequence (no
    internal clocks — ``now`` is a caller-supplied timestamp, wall seconds
    in the threaded runner, the iteration counter in ``StragglerSchedule``).
    """

    def __init__(self, config: Optional[PolicyConfig] = None, n_slots: int = 0):
        self.config = (config or PolicyConfig()).validate()
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        # guarded-by-writes: _lock — fixed slot list; states move under _lock,
        # lock-free reads (state/demoted_slots) see a coherent latest state
        self._slots = [_SlotState() for _ in range(self.n_slots)]
        # (now, slot, from_state, to_state) — observability + tests
        self.transitions: List[Tuple[float, int, str, str]] = []  # guarded-by-writes: _lock
        # observe() may be called from two threads (the shadow round AND the
        # supervisor's tick while the shadow thread is down/restarting)
        self._lock = threading.Lock()

    def demoted_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.state in (DEMOTED, PROBATION)]

    def state(self, slot: int) -> str:
        return self._slots[slot].state

    def _move(self, now: float, slot: int, to: str) -> None:  # holds-lock: _lock
        st = self._slots[slot]
        self.transitions.append((now, slot, st.state, to))
        st.state, st.since = to, now

    def observe(
        self,
        now: float,
        eps_by_slot: Mapping[int, float],
        active: Sequence[bool],
        eligible: Optional[Sequence[bool]] = None,
        *,
        loss_by_slot: Optional[Mapping[int, float]] = None,
        staleness_by_slot: Optional[Mapping[int, float]] = None,
    ) -> List[PolicyAction]:
        """One controller round.

        ``active``: the membership mask (who is currently training AND
        syncing). ``eligible``: slots with a live host behind them (the
        threaded runner passes its thread-alive flags so a trainer that
        simply FINISHED — whose rate decays to zero — is neither demoted
        nor re-admitted); defaults to all-eligible. ``loss_by_slot`` /
        ``staleness_by_slot``: optional quality observations (per-slot loss
        EMA, seconds/iterations since the slot's last landed sync) — only
        consulted when the matching ``PolicyConfig`` knob is set.
        """
        with self._lock:
            return self._observe_locked(
                now, eps_by_slot, active, eligible,
                loss_by_slot=loss_by_slot, staleness_by_slot=staleness_by_slot)

    # holds-lock: _lock
    def _observe_locked(
        self,
        now: float,
        eps_by_slot: Mapping[int, float],
        active: Sequence[bool],
        eligible: Optional[Sequence[bool]],
        *,
        loss_by_slot: Optional[Mapping[int, float]] = None,
        staleness_by_slot: Optional[Mapping[int, float]] = None,
    ) -> List[PolicyAction]:
        cfg = self.config
        if eligible is None:
            eligible = [True] * self.n_slots
        live = [i for i in range(self.n_slots) if i < len(active) and active[i] and eligible[i]]
        # The median's base is the live cohort PLUS our own demoted slots,
        # so probation probes stay comparable to the cohort that demoted
        # them. One straggler among R cannot drag the median: it is the
        # middle, not the mean. (If the base ever degenerates to a demoted
        # slot alone, re-admission falls back to that slot's demotion-time
        # reference median — see below.)
        base = [i for i in range(self.n_slots)
                if eligible[i] and ((i < len(active) and active[i])
                                    or self._slots[i].state in (DEMOTED,
                                                                PROBATION))]
        median = median_eps(eps_by_slot.get(i, 0.0) for i in base)
        actions: List[PolicyAction] = []
        if median <= 0.0:
            return actions  # no signal yet (startup) — never act blind
        floor = cfg.eps_floor_frac * median
        n_live = len(live)
        # cohort median loss for the divergence check: over the live slots
        # with a finite observation (a slot with no loss yet never skews it)
        loss_med = 0.0
        if cfg.loss_div_frac is not None and loss_by_slot:
            lv = [float(loss_by_slot[i]) for i in live
                  if i in loss_by_slot and float(loss_by_slot[i]) == float(loss_by_slot[i])]
            if len(lv) >= 2:
                loss_med = median_eps(lv)

        def _breach(slot: int, eps: float) -> Optional[str]:
            # pace first (the original signal), then the quality signals —
            # the FIRST breach names the demotion, so provenance stays
            # single-cause and parseable
            if eps < floor:
                return (f"straggler: eps {eps:.0f} < "
                        f"{cfg.eps_floor_frac:.2f} x live median {median:.0f} "
                        f"for {cfg.window_s:g}s")
            if cfg.loss_div_frac is not None and loss_med > 0.0 and loss_by_slot:
                loss = float(loss_by_slot.get(slot, float("nan")))
                if loss == loss and loss > (1.0 + cfg.loss_div_frac) * loss_med:
                    return (f"loss-divergence: loss {loss:.4f} > "
                            f"(1 + {cfg.loss_div_frac:g}) x cohort median "
                            f"{loss_med:.4f} for {cfg.window_s:g}s")
            if cfg.staleness_max is not None and staleness_by_slot is not None:
                age = float(staleness_by_slot.get(slot, 0.0))
                if age > cfg.staleness_max:
                    return (f"staleness: {age:.3g} since last landed sync > "
                            f"{cfg.staleness_max:g} for {cfg.window_s:g}s")
            return None

        for slot in range(self.n_slots):
            st = self._slots[slot]
            eps = eps_by_slot.get(slot, 0.0)
            if st.state in (HEALTHY, SUSPECT):
                if slot not in live:
                    # crashed / left / finished outside our control: forget
                    # any suspicion, but the slot is not ours to re-admit
                    if st.state == SUSPECT:
                        self._move(now, slot, HEALTHY)
                    continue
                reason = _breach(slot, eps)
                if reason is None:
                    if st.state == SUSPECT:
                        self._move(now, slot, HEALTHY)
                    continue
                if st.state == HEALTHY:
                    self._move(now, slot, SUSPECT)
                    continue
                # suspect with the breach still in force
                if now - st.since >= cfg.window_s and n_live > cfg.min_active:
                    st.ref_eps = median  # the bar it must clear to return
                    self._move(now, slot, DEMOTED)
                    n_live -= 1
                    actions.append(PolicyAction("demote", slot, reason))
            else:  # DEMOTED | PROBATION — only slots WE demoted get here
                if not eligible[slot]:
                    continue  # host gone; hold state, never re-admit a ghost
                # when no OTHER eligible slot remains, the median degenerates
                # to this slot's own rate and any pace would pass — hold it
                # to the median it was demoted against instead
                ref = (median if any(i != slot for i in base) else st.ref_eps)
                # a still-divergent loss fails the probe too — pace alone
                # must not re-admit a slot whose trajectory is off the rails
                # (staleness deliberately NOT consulted: a demoted slot's
                # sync age grows by construction)
                diverged = (
                    cfg.loss_div_frac is not None and loss_med > 0.0
                    and loss_by_slot is not None
                    and float(loss_by_slot.get(slot, loss_med))
                    > (1.0 + cfg.loss_div_frac) * loss_med)
                if ref <= 0.0 or eps < cfg.readmit_frac * ref or diverged:
                    if st.state == PROBATION:
                        self._move(now, slot, DEMOTED)
                    continue
                if st.state == DEMOTED:
                    self._move(now, slot, PROBATION)
                    continue
                if now - st.since >= cfg.probation_s:
                    self._move(now, slot, HEALTHY)
                    actions.append(PolicyAction(
                        "readmit", slot,
                        f"probation passed: eps {eps:.0f} >= "
                        f"{cfg.readmit_frac:.2f} x reference median "
                        f"{ref:.0f} for {cfg.probation_s:g}s"))
        return actions


class StragglerSchedule(MembershipSchedule):
    """Adapt a ``StragglerPolicy`` into the deterministic event source
    ``HogwildSim`` already consumes (``events_at(t)``), so closed-loop
    demotion/re-admission is reproducible in the simulator.

    The per-slot rates come from ``rates(t, slot)`` — a scripted trace (the
    sim itself is deterministic, so "slowness" must be declared, exactly
    like ``FaultSpec`` declares crashes). The policy's clock is the
    iteration counter: ``window_s`` / ``probation_s`` are read in
    iterations here.

    Events are generated lazily as the sim asks for each iteration and
    cached, so re-reading an earlier iteration (or ``__iter__``) replays
    rather than re-evaluating.
    """

    def __init__(
        self,
        policy: StragglerPolicy,
        rates: Callable[[int, int], float],
        *,
        start_active: Optional[Sequence[bool]] = None,
        losses: Optional[Callable[[int, int], float]] = None,
        staleness: Optional[Callable[[int, int], float]] = None,
    ):
        super().__init__([])
        self.policy = policy
        self.rates = rates
        # optional quality traces (scripted, like rates): per-slot loss EMA
        # and sync-staleness age feeding the PolicyConfig quality knobs
        self.losses = losses
        self.staleness = staleness
        n = policy.n_slots
        self._active = ([True] * n if start_active is None else [bool(b) for b in start_active])
        if len(self._active) != n:
            raise ValueError(f"start_active has {len(self._active)} slots, " f"policy has {n}")
        self._emitted: Dict[int, List[Tuple[str, int, str]]] = {}
        self._next_t = 0

    def max_slot(self) -> int:
        return self.policy.n_slots - 1

    def events_at(self, t: int) -> List[Tuple[str, int, str]]:
        # evaluate every iteration up to t exactly once (the sim calls with
        # monotonically increasing t; a resumed run skips the gap in one go)
        while self._next_t <= t:
            tt = self._next_t
            self._next_t += 1
            n = self.policy.n_slots
            eps = {s: float(self.rates(tt, s)) for s in range(n)}
            loss_by = (
                {s: float(self.losses(tt, s)) for s in range(n)}
                if self.losses is not None else None)
            stale_by = (
                {s: float(self.staleness(tt, s)) for s in range(n)}
                if self.staleness is not None else None)
            out: List[Tuple[str, int, str]] = []
            for a in self.policy.observe(
                    float(tt), eps, list(self._active),
                    loss_by_slot=loss_by, staleness_by_slot=stale_by):
                kind = "leave" if a.kind == "demote" else "join"
                self._active[a.slot] = a.kind == "readmit"
                out.append((kind, a.slot, a.reason))
            if out:
                self._emitted[tt] = out
        return self._emitted.get(t, [])

    def __iter__(self):
        return iter(
            (t, kind, slot) for t, evs in sorted(self._emitted.items()) for kind, slot, _ in evs
        )

    def __len__(self) -> int:
        return sum(len(v) for v in self._emitted.values())
