"""Step pipelining with a hazard-checked double buffer, the port's own copy
of ``repro/core/pipeline.py`` (host-side scheduling; the runners supply the
device work).

A training step serializes embedding lookup -> dense forward/backward ->
sparse-Adagrad update, although the batch stream is a pure function of
``(seed, iteration)``. NestPipe (PAPERS.md) overlaps the PS lookup of batch
k+1 with the dense pass of batch k; BagPipe shows the deterministic
lookahead admits exact, semantics-preserving overlap. ``StepPipeline`` is
that move for both runners (DESIGN.md §13):

* a background **staging worker** peeks future batches (``prepare``, pure in
  the iteration counter) and dispatches their per-shard lookups
  (``stage_fn``) up to ``depth - 1`` steps ahead;
* the training thread calls ``consume(t)`` at the top of step ``t`` (a
  staged pooled plane, or None -> run the lookup serially), ``stage(t)``
  once the dense pass is dispatched but BEFORE step ``t``'s sparse update
  (so a ``make_ctx`` capture predates the update), and ``drain()`` before
  any membership epoch advances.

**Hazard rule (read-after-write, deterministic).** A lookup staged for
batch ``j`` from the context of batch ``base`` races the sparse updates of
batches ``[base, j)``, which have not landed when it dispatches. Per shard,
the rows batch ``k`` updates are exactly the rows it reads, so the staged
lookup is bitwise the serial one iff batch ``j``'s row set is disjoint from
every window batch's row set on that shard. The worker checks that
disjointness over the peeked index stream; a colliding shard is NOT staged
and its lookup runs serially at consume time, after the updates landed
(counted in ``hazard_serialized``). Both paths are exact, so the pipelined
trajectory is bitwise the serial one.

**Drain semantics.** The owner calls ``drain()`` before a membership epoch
advances (the sim), and ``consume`` re-validates the ``epoch`` and per-shard
``shard_token`` captured at staging time (the threaded runner: membership
epoch + PS store incarnation); any mismatch discards the staged value
(counted in ``drains``) and the lookup reruns serially.

The worker catches every exception (a staging failure degrades the run to
serial, it never kills it: ``worker_errors``, which callers must report),
and no device work runs under the pipeline lock.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

Prep = Dict[str, Any]


@dataclass(frozen=True)
class PipelineConfig:
    """``depth`` is the number of in-flight steps including the one being
    consumed: depth 1 is the serial loop (nothing staged, no worker thread),
    depth 2 double-buffers (batch k+1's lookup dispatches while batch k's
    dense pass runs), depth d keeps d-1 lookups staged ahead."""

    depth: int = 2

    def validate(self) -> "PipelineConfig":
        if self.depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {self.depth}")
        return self


@dataclass
class PipelineStats:
    steps: int = 0  # consume() calls (pipelined training steps)
    shard_steps: int = 0  # steps x shards: the overlap-rate denominator
    overlapped: int = 0  # shard-steps served from a staged lookup
    hazard_serialized: int = 0  # shard-steps the RAW hazard forced serial
    drains: int = 0  # staged work discarded (drain()/epoch/incarnation)
    worker_errors: int = 0  # staging exceptions (the run degrades to serial)

    @property
    def overlap_rate(self) -> float:
        return self.overlapped / max(self.shard_steps, 1)

    def add(self, other: "PipelineStats") -> "PipelineStats":
        for k, v in other.__dict__.items():
            setattr(self, k, getattr(self, k) + v)
        return self

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.__dict__)
        d["overlap_rate"] = self.overlap_rate
        return d


class _Staged:
    """One in-flight pipeline entry. The worker writes ``vals``/``tokens``/
    ``prep`` then sets ``done`` — the Event publish is the happens-before
    edge the consuming thread reads through."""

    __slots__ = ("it", "base", "gen", "epoch0", "ctx", "done", "vals", "tokens", "prep")

    def __init__(self, it: int, base: int, gen: int, epoch0: Any, ctx: Any):
        self.it = it  # iteration this entry stages
        self.base = base  # consuming step when it was staged (window start)
        self.gen = gen  # drain generation at staging time
        self.epoch0 = epoch0  # membership epoch at staging time
        self.ctx = ctx  # owner-thread context (e.g. pre-update emb state)
        self.done = threading.Event()
        self.vals: Optional[List[Any]] = None  # per-shard staged lookups
        self.tokens: Optional[List[Any]] = None  # per-shard tokens at dispatch
        self.prep: Optional[Prep] = None  # the worker's peeked batch/rows


class StepPipeline:
    """Double-buffered step pipeline over ``n_shards`` independent lookup
    units (the per-PS shards of the threaded runner; one unit for the sim's
    packed table).

    Callbacks (all provided by the owning runner):

    * ``prepare(it) -> {"rows": [per-shard unique row ids], ...}`` — peek
      iteration ``it``'s batch. Pure in ``it`` (the deterministic stream),
      called on the worker thread; whatever else it returns (the generated
      batch, routed indices) rides back through ``consume`` so the owner
      never regenerates a peeked batch.
    * ``stage_fn(s, it, prep, ctx)`` — dispatch shard ``s``'s fused lookup
      for iteration ``it``. Called on the worker, never under a lock.
    * ``make_ctx()`` — optional owner-thread capture at ``stage()`` time,
      after the dense dispatch and before the sparse update. The port's
      runners update the tables IN PLACE on the owner's CUDA stream, so the
      context they return is the owner's state together with a CUDA event
      recorded on the owner's stream at that point (``streams.record``);
      ``stage_fn`` runs on the stager's own stream, which waits on that
      event before it launches the lookup. The event orders every update
      of a batch before ``base`` ahead of the staged read; the hazard rule
      covers the updates of ``[base, j)``. ``stage_fn`` returns its planes
      (and ``prepare`` the batch it made on the device) as
      ``streams.Published``, which the owner ``consume``s.
    * ``epoch()`` / ``shard_token(s)`` — optional validity tokens captured
      at staging and re-checked at consumption; any change discards the
      staged value (a counted drain, never a wrong read).

    Thread model: ``stage``/``consume``/``drain``/``close`` run on the
    OWNING training thread only; the single staging worker communicates via
    the job queue and per-entry Events; shared counters sit under ``_lock``.
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        n_shards: int,
        *,
        prepare: Callable[[int], Prep],
        stage_fn: Callable[[int, int, Prep, Any], Any],
        make_ctx: Optional[Callable[[], Any]] = None,
        epoch: Optional[Callable[[], Any]] = None,
        shard_token: Optional[Callable[[int], Any]] = None,
        end: Optional[int] = None,
        name: str = "pipeline",
    ):
        self.cfg = cfg.validate()
        self.n_shards = int(n_shards)
        self._prepare = prepare
        self._stage_fn = stage_fn
        self._make_ctx = make_ctx
        self._epoch = epoch
        self._shard_token = shard_token
        self._end = end  # first iteration past the stream (never staged)
        self._lock = threading.Lock()
        self._stats = PipelineStats()  # guarded-by: _lock
        self._gen = 0  # guarded-by: _lock — drain generation fence
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        self._disabled = False  # guarded-by: _lock — set on worker error
        # hogwild-race: ok — owner-thread-confined (stage/consume/drain all
        # run on the one training thread that owns this pipeline)
        self._buf: Dict[int, _Staged] = {}
        # hogwild-race: ok — worker-thread-confined peek memo
        self._prep_memo: Dict[int, Prep] = {}
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._worker: Optional[threading.Thread] = None
        if self.cfg.depth > 1:
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"{name}-stager", daemon=True
            )
            self._worker.start()

    # -- owner-thread API ----------------------------------------------------
    def stage(self, t: int) -> None:
        """Queue the lookups of iterations ``(t, t + depth)`` that are not
        already in flight. Call AFTER step ``t``'s dense dispatch (the
        worker then overlaps its staging with the dense execution) and
        BEFORE step ``t``'s sparse update, so ``make_ctx`` captures the
        pre-update state the hazard rule reasons about."""
        if self._worker is None:
            return
        with self._lock:
            if self._disabled:
                return
            gen = self._gen
        epoch0 = self._epoch() if self._epoch is not None else None
        for j in range(t + 1, t + self.cfg.depth):
            if self._end is not None and j >= self._end:
                break
            if j in self._buf:
                continue
            ctx = self._make_ctx() if self._make_ctx is not None else None
            entry = _Staged(j, t, gen, epoch0, ctx)
            self._buf[j] = entry
            self._q.put(entry)

    def consume(self, t: int) -> tuple:
        """-> ``(vals, prep)``: per-shard staged lookups (``None`` entries
        run serially — never staged, hazard-serialized, or drained) plus the
        worker's peeked prep for ``t`` (``None`` -> regenerate)."""
        with self._lock:
            self._stats.steps += 1
            self._stats.shard_steps += self.n_shards
        entry = self._buf.pop(t, None)
        if entry is None:
            return [None] * self.n_shards, None
        # The worker always publishes (its error path publishes Nones); an
        # unpublished entry with a dead worker means the job was never
        # dequeued — fall back to serial rather than wait forever.
        while not entry.done.wait(timeout=1.0):
            if self._worker is None or not self._worker.is_alive():
                return [None] * self.n_shards, None
        vals, tokens, prep = entry.vals, entry.tokens, entry.prep
        with self._lock:
            stale = entry.gen != self._gen
        if stale or (self._epoch is not None and self._epoch() != entry.epoch0):
            # an elastic event advanced under this entry: discard the staged
            # lookups (prep is iteration-pure, so it stays reusable)
            with self._lock:
                self._stats.drains += 1
            return [None] * self.n_shards, prep
        out: List[Any] = []
        overlapped = drained = 0
        for s in range(self.n_shards):
            v = vals[s] if vals is not None else None
            if (
                v is not None
                and self._shard_token is not None
                and self._shard_token(s) != tokens[s]
            ):
                drained += 1  # e.g. the PS failed/recovered mid-stage
                v = None
            if v is not None:
                overlapped += 1
            out.append(v)
        with self._lock:
            self._stats.overlapped += overlapped
            self._stats.drains += drained
        return out, prep

    def drain(self) -> None:
        """Discard every in-flight stage. The owner calls this BEFORE a
        membership epoch advances (demote/crash/join, PS fail): staged
        lookups captured pre-event must not serve post-event steps."""
        if not self._buf:
            return
        with self._lock:
            self._gen += 1  # queued-but-unstarted jobs are fenced out
            self._stats.drains += len(self._buf)
        self._buf.clear()

    def close(self) -> None:
        """Stop the staging worker (sentinel + join). Idempotent."""
        worker, self._worker = self._worker, None
        if worker is None:
            return
        self._q.put(None)
        worker.join(timeout=5.0)
        self._buf.clear()

    @property
    def stats(self) -> PipelineStats:
        with self._lock:
            return PipelineStats(**self._stats.__dict__)

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    # -- staging worker ------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            entry = self._q.get()
            if entry is None:
                return
            with self._lock:
                stale = entry.gen != self._gen
                disabled = self._disabled
            if stale:
                continue  # drained while queued; never consumed
            if disabled:
                self._publish_empty(entry)
                continue
            try:
                self._run_job(entry)
            except BaseException as e:  # noqa: BLE001 — a staging failure
                # must degrade to serial, never reach threading.excepthook
                with self._lock:
                    self._error = e
                    self._stats.worker_errors += 1
                    self._disabled = True
                self._publish_empty(entry)

    def _publish_empty(self, entry: _Staged) -> None:
        entry.vals = [None] * self.n_shards
        entry.tokens = [None] * self.n_shards
        entry.done.set()

    def _run_job(self, entry: _Staged) -> None:
        j = entry.it
        prep_j = self._prep_of(j)
        rows_j = prep_j["rows"]
        window = [self._prep_of(k)["rows"] for k in range(entry.base, j)]
        vals: List[Any] = [None] * self.n_shards
        tokens: List[Any] = [None] * self.n_shards
        hazards = 0
        for s in range(self.n_shards):
            # read-after-write hazard: batch j reads a row some window batch
            # will update -> do NOT stage this shard (its serial lookup at
            # consume time sees the landed updates — exactness over overlap)
            if any(len(np.intersect1d(rows_j[s], w[s], assume_unique=True)) for w in window):
                hazards += 1
                continue
            if self._shard_token is not None:
                tokens[s] = self._shard_token(s)
            vals[s] = self._stage_fn(s, j, prep_j, entry.ctx)
        if hazards:
            with self._lock:
                self._stats.hazard_serialized += hazards
        # prune the peek memo below the oldest window any future job can need
        for k in [k for k in self._prep_memo if k < entry.base]:
            del self._prep_memo[k]
        entry.prep = prep_j
        entry.vals = vals
        entry.tokens = tokens
        entry.done.set()

    def _prep_of(self, it: int) -> Prep:
        p = self._prep_memo.get(it)
        if p is None:
            p = self._prepare(it)
            self._prep_memo[it] = p
        return p
