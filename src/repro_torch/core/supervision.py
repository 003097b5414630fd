"""Failure-domain supervision: heartbeats, bounded restarts, degradation.
The port's own copy of ``repro/core/supervision.py`` (host-only).

ShadowSync's isolation property (paper §3.3) cuts both ways: because training
never blocks on the sync engine, the sync engine can die and training will
*silently* continue as unsynchronized Hogwild forever. Trainer slots are a
supervised failure domain (membership + the straggler controller); this
module extends the same closed-loop treatment to the remaining
long-lived threads — the shadow/sync thread, the fixed-rate monitor — and to
any other component that can express "I am alive" as a heartbeat.

``Supervisor`` owns three mechanisms (DESIGN.md §10):

* **Heartbeat registry** — every supervised thread registers under a name and
  beats its heartbeat as it makes progress (a shadow round, a trainer
  iteration). A thread is *failed* when its ``threading.Thread`` object is no
  longer alive, and *stalled* when its heartbeat is older than
  ``heartbeat_deadline_s`` while the thread still nominally runs (e.g. wedged
  inside a blocking call).

* **Restart policy** — a registration may carry a ``restart`` factory. When
  the thread fails or stalls, the supervisor starts a replacement through the
  factory after an exponential backoff (``backoff_s * backoff_factor **
  attempt``), up to ``max_restarts`` attempts. ShadowSync makes this safe for
  the sync thread specifically: training never blocked on it, so a restarted
  shadow thread simply resumes background rounds against the *live*
  membership state. Restart budgets are per-name and never reset — a
  crash-looping component converges to escalation instead of flapping.

* **Degradation ladder** — when the restart budget is exhausted (or the
  registration is watch-only), the supervisor *escalates*: it calls the
  registration's ``on_give_up`` callback exactly once and marks the name
  degraded. The runner's ladder for the sync engine is: keep training
  locally (isolation means nothing breaks), log a ``degraded`` membership
  event with provenance, and force one final foreground sync at shutdown so
  the run still converges to a synchronized model (core/runners.py).

Watch-only registrations (``restart=None``, e.g. trainer threads, whose
state is slot-owned and already supervised by membership + the straggler
policy) get stall/failed *detection* — a ``stall`` event with provenance —
but never a restart.

The watch loop also drives a caller-supplied ``tick`` callback every check
interval. ``ThreadedShadowRunner`` points it at the straggler-policy step, so
the scheduler keeps its clock even while the thread that normally evaluates
it (the shadow thread) is the thing being restarted — the supervisor and the
policy share one clock domain (``time.perf_counter``), which is why
``StragglerPolicy.observe`` is now lock-guarded (core/scheduler.py).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class SupervisorConfig:
    """Tuning knobs for the supervision loop (DESIGN.md §10.1)."""

    heartbeat_deadline_s: float = 5.0  # stale beyond this => stalled
    check_interval_s: float = 0.02     # watch-loop cadence
    max_restarts: int = 3              # per supervised name, never reset
    backoff_s: float = 0.1             # first restart delay
    backoff_factor: float = 2.0        # exponential growth per attempt

    def validate(self) -> "SupervisorConfig":
        if self.heartbeat_deadline_s <= 0:
            raise ValueError(
                f"heartbeat_deadline_s must be > 0, got " f"{self.heartbeat_deadline_s}"
            )
        if self.check_interval_s <= 0:
            raise ValueError(f"check_interval_s must be > 0, got " f"{self.check_interval_s}")
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got " f"{self.max_restarts}")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError(
                f"need backoff_s >= 0 and backoff_factor >= 1, "
                f"got backoff_s={self.backoff_s}, "
                f"backoff_factor={self.backoff_factor}"
            )
        return self


@dataclass(frozen=True)
class SupervisionEvent:
    """One supervision decision, with provenance for logs and CI floors.

    ``kind``: ``"stall"`` (heartbeat went stale), ``"death"`` (thread object
    no longer alive), ``"restart"`` (replacement started), ``"degraded"``
    (restart budget exhausted / watch-only give-up). ``t`` is
    ``time.perf_counter`` — the same clock domain the straggler policy and
    the membership event log use."""

    kind: str
    name: str
    t: float
    reason: str = ""


@dataclass
class _Supervised:
    thread: threading.Thread
    restart: Optional[Callable[[], threading.Thread]]
    on_give_up: Optional[Callable[[str], None]]
    last_beat: float = 0.0
    restarts: int = 0
    degraded: bool = False
    # pending failure: time the death/stall was first seen (backoff anchors
    # here); None when the thread is currently believed healthy
    failed_at: Optional[float] = None
    failure_reason: str = ""
    # a stalled-but-alive thread we walked away from: its generation token
    # is bumped so the zombie exits at its next round boundary instead of
    # fighting its replacement
    generation: int = 0


class Supervisor:
    """Heartbeat-driven thread supervision with bounded restarts.

    Thread-safety: ``beat`` is called from the supervised threads, ``register``
    / ``deregister`` from whoever owns them, and the watch loop from the
    supervisor's own thread — all state transitions take ``_lock``. The
    ``restart`` factory and ``on_give_up`` callback are invoked *outside* the
    lock (they start threads / take runner locks of their own).
    """

    def __init__(
        self,
        config: Optional[SupervisorConfig] = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
        tick: Optional[Callable[[], None]] = None,
    ):
        self.config = (config or SupervisorConfig()).validate()
        self.clock = clock
        self.tick = tick
        self._lock = threading.Lock()
        # guarded-by-writes: _lock — registry mutates under _lock; beat() and
        # the name-keyed getters do lock-free dict reads (never iterate)
        self._sup: Dict[str, _Supervised] = {}
        self._stop = threading.Event()
        # hogwild-race: ok — start/stop are caller-serialized lifecycle methods
        self._thread: Optional[threading.Thread] = None
        # hogwild-race: ok — the single watch thread appends; readers snapshot post-run
        self.events: List[SupervisionEvent] = []

    # -- registry ------------------------------------------------------------
    def register(
        self,
        name: str,
        thread: threading.Thread,
        *,
        restart: Optional[Callable[[], threading.Thread]] = None,
        on_give_up: Optional[Callable[[str], None]] = None,
    ) -> None:
        """Supervise ``thread`` under ``name``. ``restart`` (if given) must
        return a NEW started thread continuing the same work; ``on_give_up``
        fires exactly once when the restart budget is exhausted (or, for
        watch-only registrations, on the first failure)."""
        with self._lock:
            if name in self._sup:
                raise ValueError(f"{name!r} is already supervised")
            self._sup[name] = _Supervised(
                thread=thread, restart=restart, on_give_up=on_give_up, last_beat=self.clock()
            )

    def beat(self, name: str) -> None:
        """Record liveness progress for ``name`` (cheap; called per round /
        per iteration from the supervised thread itself)."""
        s = self._sup.get(name)
        if s is not None:
            s.last_beat = self.clock()  # single float store: atomic enough

    def deregister(self, name: str) -> None:
        """Clean exit: the thread finished its work; stop watching it."""
        with self._lock:
            self._sup.pop(name, None)

    def generation(self, name: str) -> int:
        """Current generation token for ``name``. A supervised loop should
        capture its generation at spawn and exit once it is superseded —
        that is how a stalled-but-alive zombie stands down after the
        supervisor has already started its replacement."""
        s = self._sup.get(name)
        return s.generation if s is not None else 0

    def thread(self, name: str) -> Optional[threading.Thread]:
        """The CURRENT thread object for ``name`` (follows restarts)."""
        s = self._sup.get(name)
        return s.thread if s is not None else None

    def is_degraded(self, name: str) -> bool:
        s = self._sup.get(name)
        return bool(s is not None and s.degraded)

    def restarts(self, name: str) -> int:
        s = self._sup.get(name)
        return s.restarts if s is not None else 0

    def degraded_names(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._sup.items() if s.degraded]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch_loop, name="supervisor", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    # -- the watch loop ------------------------------------------------------
    def _watch_loop(self) -> None:
        while not self._stop.wait(self.config.check_interval_s):
            try:
                self.check_once()
            except Exception:  # supervision must outlive a bad callback
                pass
            if self.tick is not None:
                try:
                    self.tick()
                except Exception:
                    pass

    def check_once(self) -> List[SupervisionEvent]:
        """One supervision pass (public for deterministic tests: drive it
        with an injected clock instead of the background loop). Returns the
        events emitted this pass."""
        now = self.clock()
        cfg = self.config
        emitted: List[SupervisionEvent] = []
        to_restart: List[tuple] = []
        to_give_up: List[tuple] = []
        with self._lock:
            for name, s in self._sup.items():
                if s.degraded:
                    continue
                if s.failed_at is None:
                    alive = s.thread.is_alive()
                    stale = now - s.last_beat > cfg.heartbeat_deadline_s
                    if alive and not stale:
                        continue
                    kind = "death" if not alive else "stall"
                    s.failed_at = now
                    s.failure_reason = (
                        f"thread exited" if not alive else
                        f"heartbeat stale {now - s.last_beat:.2f}s > "
                        f"deadline {cfg.heartbeat_deadline_s:g}s")
                    ev = SupervisionEvent(kind, name, now, s.failure_reason)
                    self.events.append(ev)
                    emitted.append(ev)
                    if not alive and s.restart is None:
                        # watch-only + clean-ish death: give up immediately
                        pass
                # pending failure: restart after backoff, or escalate
                if s.restart is not None and s.restarts < cfg.max_restarts:
                    due = s.failed_at + cfg.backoff_s * (cfg.backoff_factor ** s.restarts)
                    if now >= due:
                        s.restarts += 1
                        s.generation += 1  # fence out a stalled zombie
                        to_restart.append((name, s))
                else:
                    s.degraded = True
                    to_give_up.append((name, s))
        for name, s in to_restart:
            new_thread = s.restart()
            with self._lock:
                s.thread = new_thread
                s.failed_at = None
                s.last_beat = self.clock()
            ev = SupervisionEvent(
                "restart",
                name,
                self.clock(),
                f"attempt {s.restarts}/{cfg.max_restarts} after " f"{s.failure_reason}",
            )
            self.events.append(ev)
            emitted.append(ev)
        for name, s in to_give_up:
            ev = SupervisionEvent(
                "degraded", name, self.clock(),
                f"restart budget exhausted "
                f"({s.restarts}/{cfg.max_restarts}) after "
                f"{s.failure_reason}" if s.restart is not None else
                f"watch-only: {s.failure_reason}")
            self.events.append(ev)
            emitted.append(ev)
            if s.on_give_up is not None:
                s.on_give_up(name)
        return emitted
