"""Elastic replica membership: join/leave/fail as a first-class runtime concept.
The port's own copy of ``repro/core/membership.py`` (host-only, numpy).

ShadowSync's central systems claim is that decoupling synchronization from
training buys robustness and elasticity (paper §1, §3.3): a slow or dead
trainer cannot block the others, and capacity can change mid-run. This module
is the one place that truth lives:

* ``Membership`` — a thread-safe replica slot table with capacity ``R_max``,
  a per-slot status (``active | joining | dead``), a monotonically increasing
  epoch (bumped on every transition), and an event log. Every layer of the
  sync stack consumes it instead of a frozen ``R``:

  - ``FlatSpace`` buffers are allocated capacity-padded at ``(R_max, n_rows,
    128)`` once; join/leave/fail never reallocate or retrace — only the
    active mask changes (DESIGN.md §8).
  - The fused sync kernels take the active row set via scalar prefetch, so a
    dead slot costs zero HBM traffic; MA/BMUF means divide by the LIVE
    count; gossip's rotating matching is drawn over the active set only.
  - ``SyncAlgorithm.on_join`` / ``on_leave`` bootstrap/drop replicas through
    the registry, so every algorithm gets elasticity for free.
  - ``ThreadedShadowRunner``'s shadow thread reads membership each round and
    simply skips dead slots — training never blocks on a crash.

* ``MembershipSchedule`` — a deterministic (iteration, event, slot) script
  for reproducible elasticity experiments in ``HogwildSim``.

* ``FaultSpec`` — the ThreadedShadowRunner fault-injection harness config:
  per-slot straggler slowdown, crash-at-iteration, join-at-iteration, plus
  the chaos domains — sync-thread crash/stall rounds, trainer
  exceptions, and PS-shard loss (DESIGN.md §10).

Transitions (anything else raises ``ValueError``):

    dead --join--> joining --activate--> active --fail/leave--> dead
                   joining --fail-----------------------------> dead

Besides slot transitions, the event log also carries *annotations*
(``Membership.note``): non-transition events from the other failure domains
— ``degraded`` (the supervisor exhausted the sync engine's restart budget),
``sync_restart``, ``ps_fail`` / ``ps_recover`` (``slot`` is the SHARD id
there) — so one log tells the whole robustness story with provenance.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

DEAD = 0
ACTIVE = 1
JOINING = 2

_STATUS_NAMES = {DEAD: "dead", ACTIVE: "active", JOINING: "joining"}


@dataclass(frozen=True)
class MembershipEvent:
    """One transition, as recorded in ``Membership.events``.

    ``reason`` is provenance: "" for legacy/injected transitions, a
    human-readable cause for controller decisions (e.g. the straggler
    policy's demotion evidence — core/scheduler.py). ``t`` is the wall
    timestamp of the transition (``time.perf_counter`` domain; diagnostics
    only — deterministic consumers compare ``(kind, slot)``)."""

    # transitions: "join" | "activate" | "leave" | "fail"
    # annotations (Membership.note — no status change, no epoch bump):
    # "degraded" | "sync_restart" | "ps_fail" | "ps_recover" (slot = shard)
    kind: str
    slot: int
    epoch: int  # epoch AFTER the transition (unchanged for annotations)
    reason: str = ""
    t: float = 0.0


class Membership:
    """Thread-safe replica slot table (capacity ``R_max``).

    Slots ``[0, n_active)`` start active; the rest start dead (spare
    capacity). All reads return copies — callers never see a mask mutate
    under them mid-round.
    """

    def __init__(self, n_active: int, R_max: Optional[int] = None):
        if R_max is None:
            R_max = n_active
        if not 0 < n_active <= R_max:
            raise ValueError(
                f"need 0 < n_active <= R_max, " f"got n_active={n_active}, R_max={R_max}"
            )
        self.R_max = int(R_max)
        self._status = np.full((self.R_max,), DEAD, np.int8)  # guarded-by: _lock
        self._status[:n_active] = ACTIVE
        self._epoch = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        # guarded-by-writes: _lock — appends serialized; readers take len()
        # prefixes of an append-only list, which is safe under the GIL.
        self.events: List[MembershipEvent] = []

    @classmethod
    def from_mask(cls, active: Sequence[bool]) -> "Membership":
        """Arbitrary initial pattern (e.g. spare slots interleaved with the
        initial cohort, as a join_at fault schedule produces)."""
        active = np.asarray(active, bool)
        if not active.any():
            raise ValueError("need at least one initially active slot")
        m = cls(1, R_max=len(active))
        m._status[:] = np.where(active, ACTIVE, DEAD)
        return m

    # -- reads ---------------------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def status(self, slot: int) -> str:
        with self._lock:
            return _STATUS_NAMES[int(self._status[slot])]

    def active_mask(self) -> np.ndarray:
        """(R_max,) bool copy — slots currently training AND syncing."""
        with self._lock:
            return self._status == ACTIVE

    def active_ids(self) -> np.ndarray:
        return np.flatnonzero(self.active_mask())

    @property
    def n_active(self) -> int:
        return int(self.active_mask().sum())

    def snapshot(self) -> Tuple[int, np.ndarray]:
        """(epoch, active_mask) read atomically — what a shadow round pins."""
        with self._lock:
            return self._epoch, self._status == ACTIVE

    # -- transitions ---------------------------------------------------------
    def _transition(
        self, slot: int, allowed: Iterable[int], to: int, kind: str, reason: str = ""
    ) -> MembershipEvent:
        if not 0 <= slot < self.R_max:
            raise ValueError(f"slot {slot} out of range [0, {self.R_max})")
        with self._lock:
            cur = int(self._status[slot])
            if cur not in allowed:
                raise ValueError(
                    f"cannot {kind} slot {slot}: status is "
                    f"{_STATUS_NAMES[cur]!r} (need "
                    f"{[_STATUS_NAMES[a] for a in allowed]})")
            self._status[slot] = to
            self._epoch += 1
            ev = MembershipEvent(kind, slot, self._epoch, reason, time.perf_counter())
            self.events.append(ev)
            return ev

    def join(self, slot: int, reason: str = "") -> MembershipEvent:
        """dead -> joining: the slot is being bootstrapped (``on_join``)."""
        return self._transition(slot, (DEAD,), JOINING, "join", reason)

    def activate(self, slot: int, reason: str = "") -> MembershipEvent:
        """joining -> active: bootstrap finished; the slot trains and syncs."""
        return self._transition(slot, (JOINING,), ACTIVE, "activate", reason)

    def leave(self, slot: int, reason: str = "") -> MembershipEvent:
        """active -> dead: planned departure (capacity scale-down or a
        straggler demotion — ``reason`` records which)."""
        return self._transition(slot, (ACTIVE,), DEAD, "leave", reason)

    def fail(self, slot: int, reason: str = "") -> MembershipEvent:
        """active|joining -> dead: crash. The sync stack just stops reading
        the slot; nothing blocks, nothing reallocates."""
        return self._transition(slot, (ACTIVE, JOINING), DEAD, "fail", reason)

    def note(self, kind: str, slot: int = -1, reason: str = "") -> MembershipEvent:
        """Append a non-transition annotation to the event log: provenance
        from the OTHER failure domains (sync-engine degradation, PS-shard
        loss/recovery) so one log tells the whole robustness story. No
        status changes, no epoch bump; ``slot`` is -1 for cohort-level
        events and the shard id for ``ps_*`` events."""
        with self._lock:
            ev = MembershipEvent(kind, slot, self._epoch, reason, time.perf_counter())
            self.events.append(ev)
            return ev

    def __repr__(self) -> str:
        with self._lock:
            s = "".join({DEAD: ".", ACTIVE: "A", JOINING: "j"}[int(x)] for x in self._status)
            return f"Membership(R_max={self.R_max}, epoch={self._epoch}, [{s}])"


# ---------------------------------------------------------------------------
# Deterministic schedule (HogwildSim) and fault harness (ThreadedShadowRunner)
# ---------------------------------------------------------------------------

_SCHEDULE_KINDS = ("fail", "leave", "join")


class MembershipSchedule:
    """Deterministic (iteration, kind, slot) script for HogwildSim.

    Events fire at the START of the named iteration, before that iteration's
    training step, in the order given. Example::

        MembershipSchedule([(6, "fail", 2), (10, "join", 2)])
    """

    def __init__(self, events: Sequence[Tuple[int, str, int]]):
        for t, kind, slot in events:
            if kind not in _SCHEDULE_KINDS:
                raise ValueError(
                    f"unknown schedule event kind {kind!r}; " f"one of {_SCHEDULE_KINDS}"
                )
            if t < 0 or slot < 0:
                raise ValueError(f"bad schedule entry {(t, kind, slot)}")
        self._events = sorted(events, key=lambda e: e[0])

    def max_slot(self) -> int:
        return max((s for _, _, s in self._events), default=-1)

    def events_at(self, t: int) -> List[Tuple[str, int]]:
        return [(kind, slot) for tt, kind, slot in self._events if tt == t]

    def __iter__(self):
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)


@dataclass(frozen=True)
class FaultSpec:
    """ThreadedShadowRunner fault-injection harness (DESIGN.md §8.4).

    * ``straggler_sleep_s[slot]`` — extra seconds slept per iteration: a
      degraded host. In ``mode="shadow"`` only that trainer slows down; in
      ``mode="fixed_rate"`` every trainer blocks at the sync barrier until
      the straggler arrives — the paper's Fig-5 contrast, restated as fault
      tolerance.
    * ``straggler_until[slot]`` — the straggler sleep applies only while the
      slot's LOCAL iteration is below this bound (a transient degradation —
      e.g. a co-tenant burst — that ends; absent means degraded for the whole
      run). This is what the closed-loop controller's re-admission story
      exercises: demote while degraded, re-admit once the pace recovers.
    * ``crash_at[slot]`` — the trainer dies (thread exits, membership
      ``fail``) when it reaches this local iteration.
    * ``join_at[slot]`` — the slot starts dead and joins (bootstrap via
      ``SyncAlgorithm.on_join``) once the initial cohort's fastest trainer
      has passed this iteration.
    * ``raise_at[slot]`` — the trainer RAISES (an injected software bug, not
      a clean simulated death) at this local iteration; exercises the
      runner's exception capture + re-raise-with-provenance path.
    * ``sync_crash_at`` — the shadow/sync thread dies (raises) at the start
      of this background ROUND (cumulative across restarts; injected once).
      The supervisor must detect the death and restart the thread against
      live membership (DESIGN.md §10.2).
    * ``sync_stall_at`` / ``sync_stall_s`` — the shadow thread STALLS (sleeps
      ``sync_stall_s`` without dying) at this round; the supervisor detects
      the stale heartbeat, fences the zombie out by generation, and starts a
      replacement.
    * ``ps_fail_at[shard]`` — embedding PS ``shard`` fails (live state lost)
      once cohort progress reaches this iteration; lookups fall back to the
      background snapshot, updates retry-then-drop (embeddings/shards.py).
    * ``ps_recover_after_s`` — seconds after a PS failure at which the
      supervisor rehydrates the shard from its snapshot (a replacement host
      coming up). Shards still down at shutdown are always rehydrated so the
      final state includes every shard.
    """

    straggler_sleep_s: Dict[int, float] = field(default_factory=dict)
    straggler_until: Dict[int, int] = field(default_factory=dict)
    crash_at: Dict[int, int] = field(default_factory=dict)
    join_at: Dict[int, int] = field(default_factory=dict)
    raise_at: Dict[int, int] = field(default_factory=dict)
    sync_crash_at: Optional[int] = None
    sync_stall_at: Optional[int] = None
    sync_stall_s: float = 10.0
    ps_fail_at: Dict[int, int] = field(default_factory=dict)
    ps_recover_after_s: float = 0.25

    def validate(self, R_max: int) -> "FaultSpec":
        for slot in self.straggler_until:
            if slot not in self.straggler_sleep_s:
                raise ValueError(
                    f"straggler_until names slot {slot} but "
                    f"straggler_sleep_s does not degrade it")
        for name, d in (
            ("straggler_sleep_s", self.straggler_sleep_s),
            ("straggler_until", self.straggler_until),
            ("crash_at", self.crash_at),
            ("join_at", self.join_at),
            ("raise_at", self.raise_at),
        ):
            for slot in d:
                if not 0 <= slot < R_max:
                    raise ValueError(f"{name} slot {slot} out of range " f"[0, {R_max})")
        for name, v in (
            ("sync_crash_at", self.sync_crash_at), ("sync_stall_at", self.sync_stall_at)
        ):
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.sync_stall_s <= 0:
            raise ValueError(f"sync_stall_s must be > 0, got " f"{self.sync_stall_s}")
        if self.ps_recover_after_s < 0:
            raise ValueError(f"ps_recover_after_s must be >= 0, got " f"{self.ps_recover_after_s}")
        for shard, it in self.ps_fail_at.items():
            if shard < 0 or it < 0:
                raise ValueError(
                    f"bad ps_fail_at entry {shard}:{it} "
                    f"(shard and iteration must be >= 0; the "
                    f"runner validates shard ids against its "
                    f"plan)"
                )
        return self
