"""Runtime lock-order and blocking-under-lock detection (lockdep) for the
port, the twin of ``repro/analysis/lockdep.py``.

The static pass in ``static_check`` is intraprocedural and registry-based;
this harness covers what it can't see. Under ``instrument()``,
``threading.Lock`` / ``threading.Condition`` construct instrumented
wrappers that report into a :class:`LockGraph`, and the kernel backend's
three module-level locks (``kernels/backend.py``: ``_BUILD_LOCK``, an RLock
that every launch takes, ``_COUNT_LOCK``, which every launch takes, and
``_INDEX_LOCK``) are swapped for instrumented ones, so the edges that a
kernel launched under a runner lock adds are in the graph:

- **acquisition graph** — every acquisition made while other locks are
  held adds an edge (held-site -> acquired-site). Locks are identified by
  *creation site* (file:line), so the per-instance locks of N shard
  stores collapse into one node and an inversion between two instances of
  the same class is still a cycle. A new edge that closes a cycle raises
  :class:`LockOrderError` in the acquiring thread immediately — the
  inversion is caught even when the interleaving never actually
  deadlocks.
- **held-lock blocking** — ``time.sleep`` and ``Thread.join`` are patched
  to fail if the calling thread holds any instrumented lock, and so are the
  host's waits on the card (``torch.cuda.synchronize``,
  ``torch.cuda.Stream.synchronize``, ``torch.cuda.Event.synchronize``) and
  on a subprocess (``subprocess.Popen.communicate`` / ``wait``: ``nvcc``).
- **stall detection** — a thread sitting in ``Condition.wait`` (or a
  blocking ``acquire``) keeps its *first* blocked timestamp until it
  finally exits the critical section, so a predicate loop that re-waits
  forever (a barrier that misses a demotion mid-wait) shows up in
  :meth:`LockGraph.stalled` no matter how short each individual timed
  wait is.

Typical use in a test::

    with lockdep.instrument() as graph:
        run_threaded_scenario()
    graph.assert_clean()
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockdepError",
    "LockOrderError",
    "BlockedUnderLockError",
    "LockGraph",
    "DepLock",
    "DepRLock",
    "DepCondition",
    "BACKEND_LOCKS",
    "instrument",
]

# The kernel backend's module-level locks, by attribute name, and the
# graph site each instrumented stand-in reports as.
BACKEND_LOCKS = {
    "_BUILD_LOCK": "backend._BUILD_LOCK",
    "_COUNT_LOCK": "backend._COUNT_LOCK",
    "_INDEX_LOCK": "backend._INDEX_LOCK",
}


class LockdepError(AssertionError):
    """Base for lockdep failures (AssertionError so pytest renders nicely)."""


class LockOrderError(LockdepError):
    """A lock acquisition closed a cycle in the acquisition-order graph."""


class BlockedUnderLockError(LockdepError):
    """A blocking call (sleep, join, a wait on the card or a subprocess) was
    made while holding an instrumented lock."""


def _creation_site(skip_files: Tuple[str, ...]) -> str:
    """First stack frame outside this module / threading internals."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(skip_files):
            return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


_SKIP_FILES = ("lockdep.py", "threading.py", "queue.py")

# Captured before instrument() can ever patch the module attributes —
# the wrappers themselves must build real primitives.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


@dataclass
class _Blocked:
    site: str
    kind: str  # "acquire" | "cond-wait"
    since: float
    thread: str


class LockGraph:
    """Shared recorder for every instrumented lock of one instrumented run."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards every field below
        self.edges: Dict[Tuple[str, str], str] = {}  # (a, b) -> recording thread
        self.sites: Set[str] = set()
        self.violations: List[str] = []
        self._held = threading.local()
        self._blocked: Dict[int, _Blocked] = {}  # thread id -> current block
        # thread id -> {cond site -> first wait ts inside the current
        # critical section}; survives timed re-waits, cleared on release
        self._wait_epoch: Dict[int, Dict[str, float]] = {}

    # -- held-lock bookkeeping (per thread; no lock needed) ----------------

    def held(self) -> List["DepLock"]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def held_sites(self) -> List[str]:
        return [lk.site for lk in self.held()]

    # -- events ------------------------------------------------------------

    def on_attempt(self, lock: "DepLock", kind: str = "acquire") -> None:
        tid = threading.get_ident()
        entry = _Blocked(lock.site, kind, time.monotonic(), threading.current_thread().name)
        with self._mu:
            self._blocked[tid] = entry
            if kind == "cond-wait":
                self._wait_epoch.setdefault(tid, {}).setdefault(lock.site, entry.since)

    def on_acquired(self, lock: "DepLock") -> None:
        tid = threading.get_ident()
        new_edges: List[Tuple[str, str]] = []
        with self._mu:
            self._blocked.pop(tid, None)
            self.sites.add(lock.site)
            for h in self.held():
                e = (h.site, lock.site)
                if e not in self.edges:
                    self.edges[e] = threading.current_thread().name
                    new_edges.append(e)
            cycle = self._find_cycle(lock.site) if new_edges else None
            if cycle is not None:
                msg = (
                    "lock-order cycle: "
                    + " -> ".join(cycle)
                    + f" (closed by {threading.current_thread().name})"
                )
                self.violations.append(msg)
        self.held().append(lock)
        if new_edges and cycle is not None:
            raise LockOrderError(msg)

    def on_released(self, lock: "DepLock") -> None:
        tid = threading.get_ident()
        stack = self.held()
        if lock in stack:
            stack.remove(lock)
        with self._mu:
            epoch = self._wait_epoch.get(tid)
            if epoch is not None:
                epoch.pop(lock.site, None)

    def on_wait_returned(self, lock: "DepLock") -> None:
        """Condition.wait re-acquired its lock; stay in the same wait epoch."""
        tid = threading.get_ident()
        with self._mu:
            self._blocked.pop(tid, None)

    def on_attempt_failed(self) -> None:
        """A timed blocking acquire gave up; the thread is no longer blocked."""
        with self._mu:
            self._blocked.pop(threading.get_ident(), None)

    def check_blocking_call(self, what: str) -> None:
        sites = self.held_sites()
        if sites:
            msg = f"{what} called while holding {sites}"
            with self._mu:
                self.violations.append(msg)
            raise BlockedUnderLockError(msg)

    # -- queries -----------------------------------------------------------

    def _find_cycle(self, start: str) -> Optional[List[str]]:
        """DFS from ``start`` back to itself over the edge set. Caller holds _mu."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        path: List[str] = [start]
        seen: Set[str] = set()

        def dfs(node: str) -> bool:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    path.append(nxt)
                    return True
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
            return False

        return path if dfs(start) else None

    def snapshot_blocked(self) -> List[_Blocked]:
        with self._mu:
            return list(self._blocked.values())

    def stalled(self, min_seconds: float) -> List[Tuple[str, str, float]]:
        """Threads continuously blocked (acquire or wait-loop) >= min_seconds.

        A ``while not pred: cond.wait(timeout)`` loop counts from its FIRST
        wait in the current critical section — timed re-waits don't reset
        the clock, so a never-satisfied predicate is visible however short
        the individual waits are.
        """
        now = time.monotonic()
        out: List[Tuple[str, str, float]] = []
        with self._mu:
            for tid, b in self._blocked.items():
                first = b.since
                if b.kind == "cond-wait":
                    first = self._wait_epoch.get(tid, {}).get(b.site, b.since)
                dt = now - first
                if dt >= min_seconds:
                    out.append((b.thread, b.site, dt))
            for tid, epoch in self._wait_epoch.items():
                if tid in self._blocked:
                    continue  # already reported above
                for site, first in epoch.items():
                    dt = now - first
                    if dt >= min_seconds:
                        name = f"thread-{tid}"
                        for t in threading.enumerate():
                            if t.ident == tid:
                                name = t.name
                        out.append((name, site, dt))
        return out

    def assert_clean(self) -> None:
        with self._mu:
            if self.violations:
                raise LockdepError("; ".join(self.violations))

    def assert_acyclic(self) -> None:
        with self._mu:
            for site in list(self.sites):
                cycle = self._find_cycle(site)
                if cycle is not None:
                    raise LockOrderError("lock-order cycle: " + " -> ".join(cycle))


class DepLock:
    """Instrumented drop-in for ``threading.Lock``."""

    def __init__(self, graph: LockGraph, site: Optional[str] = None):
        self._real = _REAL_LOCK()
        self.graph = graph
        self.site = site or _creation_site(_SKIP_FILES)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self.graph.on_attempt(self)
            ok = self._real.acquire(True, timeout)
        else:
            ok = self._real.acquire(False)
        if ok:
            self.graph.on_acquired(self)
        elif blocking:
            self.graph.on_attempt_failed()
        return ok

    def release(self) -> None:
        self.graph.on_released(self)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> "DepLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DepRLock:
    """Instrumented drop-in for ``threading.RLock``. Only the outermost
    acquire and the last release report to the graph, so a re-entry adds no
    edge (a lock held by its own thread is no cycle)."""

    def __init__(self, graph: LockGraph, site: Optional[str] = None):
        self._real = _REAL_RLOCK()
        self.graph = graph
        self.site = site or _creation_site(_SKIP_FILES)
        self._owner: Optional[int] = None  # only the holder ever reads its own id here
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            self._real.acquire()  # re-entry never blocks
            self._count += 1
            return True
        if blocking:
            self.graph.on_attempt(self)
            ok = self._real.acquire(True, timeout)
        else:
            ok = self._real.acquire(False)
        if ok:
            self._owner, self._count = me, 1
            self.graph.on_acquired(self)
        elif blocking:
            self.graph.on_attempt_failed()
        return ok

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            self.graph.on_released(self)
        self._real.release()

    def __enter__(self) -> "DepRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DepCondition:
    """Instrumented drop-in for ``threading.Condition``."""

    def __init__(self, lock: Optional[DepLock] = None, graph: Optional[LockGraph] = None):
        if graph is None and lock is not None:
            graph = lock.graph
        assert graph is not None, "DepCondition needs a graph or a DepLock"
        self.graph = graph
        self._lock = lock if lock is not None else DepLock(graph, site=None)
        self.site = self._lock.site
        self._real = _REAL_CONDITION(_REAL_LOCK())
        # the real condition wraps its own plain lock; we mirror
        # acquire/release through the DepLock bookkeeping manually
        self._lock._real = self._real._lock  # type: ignore[attr-defined]

    def acquire(self, *a, **kw) -> bool:
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "DepCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        # Condition.wait releases the lock while blocked: mirror that in
        # the held stack, but keep the wait-epoch alive for stall tracking.
        self.graph.on_attempt(self._lock, kind="cond-wait")
        held = self.graph.held()
        if self._lock in held:
            held.remove(self._lock)
        try:
            return self._real.wait(timeout)
        finally:
            held.append(self._lock)
            self.graph.on_wait_returned(self._lock)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        endtime = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            if endtime is not None:
                remaining = endtime - time.monotonic()
                if remaining <= 0:
                    break
                self.wait(remaining)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()


@contextlib.contextmanager
def instrument(graph: Optional[LockGraph] = None, patch_blocking: bool = True):
    """Patch ``threading.Lock``/``Condition`` (and optionally the blocking
    calls: ``time.sleep``, ``Thread.join``, the CUDA host waits and the
    subprocess waits) so everything constructed inside the block reports
    into one :class:`LockGraph`, which is yielded. The kernel backend's
    module-level locks are swapped for instrumented ones for the length of
    the block; enter it while no other thread is in the backend.

    Only constructions are patched — code that imported the classes
    ``from threading import Lock`` beforehand, or module-level locks made
    outside the block (other than the backend's), stay real. The port's
    threaded stack constructs its locks at instance-build time, which is
    what makes this work. Everything patched is restored on exit.
    """
    import subprocess

    import torch

    from repro_torch.kernels import backend

    g = graph if graph is not None else LockGraph()
    real_lock = threading.Lock
    real_cond = threading.Condition
    real_backend = {name: getattr(backend, name) for name in BACKEND_LOCKS}
    # (owner, attribute, real callable) of every blocking call patched
    blocking = [
        (time, "sleep", time.sleep),
        (threading.Thread, "join", threading.Thread.join),
        (torch.cuda, "synchronize", torch.cuda.synchronize),
        (torch.cuda.Stream, "synchronize", torch.cuda.Stream.synchronize),
        (torch.cuda.Event, "synchronize", torch.cuda.Event.synchronize),
        (subprocess.Popen, "communicate", subprocess.Popen.communicate),
        (subprocess.Popen, "wait", subprocess.Popen.wait),
    ]

    def _internal_caller() -> bool:
        # Primitives built by threading/queue internals (Thread._started's
        # Event, Queue's Conditions, _DummyThread bookkeeping) must stay
        # real: instrumenting them recurses through current_thread() and
        # adds pure noise to the graph.
        fn = sys._getframe(2).f_code.co_filename
        return fn.endswith(("threading.py", "queue.py"))

    def make_lock():
        if _internal_caller():
            return real_lock()
        return DepLock(g)

    def make_cond(lock=None):
        if _internal_caller():
            return real_cond(lock) if lock is not None else real_cond()
        if lock is not None and not isinstance(lock, DepLock):
            # foreign lock (e.g. an RLock): leave it uninstrumented
            return real_cond(lock)
        return DepCondition(lock, graph=g)

    def guarded(owner, name, real):
        what = f"{getattr(owner, '__name__', owner)}.{name}"

        def call(*args, **kwargs):
            g.check_blocking_call(f"{what}()")
            return real(*args, **kwargs)

        return call

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.Condition = make_cond  # type: ignore[assignment]
    for name, site in BACKEND_LOCKS.items():
        make = DepRLock if name == "_BUILD_LOCK" else DepLock
        setattr(backend, name, make(g, site=site))
    if patch_blocking:
        for owner, name, real in blocking:
            setattr(owner, name, guarded(owner, name, real))
    try:
        yield g
    finally:
        threading.Lock = real_lock  # type: ignore[assignment]
        threading.Condition = real_cond  # type: ignore[assignment]
        for name, lock in real_backend.items():
            setattr(backend, name, lock)
        if patch_blocking:
            for owner, name, real in blocking:
                setattr(owner, name, real)
