"""Spans of the port's training loops, on the profiler's clock.

``span(name)`` brackets one phase of a loop (``core/runners.py``'s
``HogwildSim`` iteration, ``core/spmd.py``'s train and sync steps,
``models/layers.py``'s training attention). Collection is off by default:
``span`` then returns one shared no-op context and records nothing, at the
cost of one check of a module global.

``collect()`` turns collection on for the duration of its ``with`` block
and yields the ``Collector``. On, a span opens
``torch.profiler.record_function(name)``, so under ``torch.profiler`` it
lies on the same timeline as the device records and the host operations;
it adds its count and host seconds to the collector, and where CUDA is in
use it records a pair of timing events on the current stream. A span's
*stream time* is the time between its two events: the device work it
enqueued plus any idle gaps of its stream inside it, not the device time
of its own kernels alone.

``backward_span(name, output, inputs)`` brackets a backward pass: it opens
when the gradient of ``output`` arrives and closes once every one of
``inputs`` that needs a gradient has its own, on the autograd engine's
thread. So the aggregate is updated under a lock. Nothing on the hot path
waits for the card: event pairs are resolved in ``Collector.report()``,
which synchronises once, or, where unresolved pairs pile up, by a
non-blocking ``query()``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_NOOP = contextlib.nullcontext()
PENDING_MAX = 512  # unresolved event pairs before a non-blocking sweep
_collector: Optional["Collector"] = None  # the collection in progress; collect() sets it


class Collector:
    """The spans of one collection: by name, (count, host seconds, stream
    seconds). ``events``: whether spans record CUDA events (stream time)."""

    def __init__(self, events: bool):
        self.events = events
        self._lock = threading.Lock()
        self._agg: Dict[str, List[float]] = {}  # guarded-by: _lock
        # (name, start event, end event) pairs not yet resolved
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []  # guarded-by: _lock

    def _add(self, name: str, host_s: float, start, end) -> None:
        with self._lock:
            agg = self._agg.setdefault(name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += host_s
            if start is not None:
                self._pending.append((name, start, end))
            sweep = len(self._pending) >= PENDING_MAX
        if sweep:
            self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Adds the stream time of each finished pair (every pair with
        ``wait``, after the caller's synchronise) and keeps the rest."""
        with self._lock:
            pending, self._pending = self._pending, []
        done: list = []
        left: list = []
        for p in pending:
            (done if wait or p[2].query() else left).append(p)
        times = [(n, s.elapsed_time(e) / 1e3) for n, s, e in done]
        with self._lock:
            self._pending[:0] = left
            for n, t in times:
                self._agg[n][2] += t

    def report(self) -> Dict[str, Dict[str, Optional[float]]]:
        """``{name: {"count", "host_s", "stream_s"}}``; ``stream_s`` is None
        without CUDA events. Synchronises the card once."""
        if self.events:
            torch.cuda.synchronize()
        self._resolve(wait=True)
        with self._lock:
            return {n: {"count": int(a[0]), "host_s": a[1],
                        "stream_s": a[2] if self.events else None}
                    for n, a in self._agg.items()}


class _Span:
    """One open span of a collection: a profiler range, a host clock and,
    with events, a start event on the current stream."""

    __slots__ = ("_c", "_name", "_rf", "_t0", "_ev")

    def __init__(self, c: Collector, name: str):
        self._c, self._name = c, name

    def __enter__(self) -> "_Span":
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._ev = None
        if self._c.events:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        host_s = time.perf_counter() - self._t0
        end = None
        if self._ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._rf.__exit__(None, None, None)
        self._c._add(self._name, host_s, self._ev, end)
        return False


def span(name: str):
    """A context that brackets a phase as the span ``name`` while a
    collection is on; the shared no-op context otherwise."""
    c = _collector
    return _NOOP if c is None else _Span(c, name)


def backward_span(name: str, output: torch.Tensor, inputs: Iterable[torch.Tensor]) -> None:
    """While a collection is on, brackets the backward pass from
    ``output``'s gradient to the gradients of ``inputs`` (those that need
    one) as the span ``name``: a gradient hook on ``output`` opens it, and
    the last of the hooks on ``inputs`` to fire closes it. The hooks
    return nothing, so no gradient changes. Registers nothing otherwise."""
    c = _collector
    if c is None or not output.requires_grad:
        return
    ins = [x for x in inputs if x.requires_grad]
    n = len(ins)
    if not n:
        return
    # the open span and the input gradients still to come, of one backward
    # pass: the autograd engine runs the hooks one after another. The hooks
    # hold no tensor: a rematerialised block frees its inputs after the
    # forward, and so must the collection.
    state: Dict[str, object] = {"span": None, "left": 0}

    def opened(grad):
        state["span"], state["left"] = _Span(c, name).__enter__(), n

    def arrived(grad):
        state["left"] -= 1
        if state["left"] == 0 and state["span"] is not None:
            state["span"].__exit__(None, None, None)
            state["span"] = None

    output.register_hook(opened)
    for x in ins:
        x.register_hook(arrived)


@contextlib.contextmanager
def collect():
    """Turns span collection on for the block and yields its
    ``Collector``; CUDA events are recorded where CUDA is initialised.
    Collections do not nest."""
    global _collector
    if _collector is not None:
        raise RuntimeError("a span collection is already on")
    c = Collector(events=torch.cuda.is_available() and torch.cuda.is_initialized())
    _collector = c
    try:
        yield c
    finally:
        _collector = None
