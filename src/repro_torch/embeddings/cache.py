"""Tiered frequency-aware embedding cache with lookahead prefetch, the twin
of ``repro/embeddings/cache.py``.

Production CTR tables outgrow the device; a software-managed cache fronts
each embedding store. ``CachedStore`` fronts ONE contiguous (rows, d)
table + accumulator pair (a PS shard of ``embeddings/shards.py``, or
``HogwildSim``'s packed collection) with two tiers:

* a **device hot tier**: a fixed-budget contiguous (H, d) table and
  accumulator, so the embedding-bag and sparse-Adagrad kernels run on it
  unchanged over hot-slot ids (the sparse Adagrad sorted by ROW id, its
  ``order_ids``, so the cached update is bitwise the uncached one);
* a **host cold store**: numpy arrays holding the canonical values of every
  row that is not hot (a hot row's entry is stale until eviction writes it
  back).

A ``Routing`` maps every row to its hot slot (-1: cold) and is published
with the hot arrays as one ``TierState``; ``merged()`` rebuilds the
canonical table exactly, so checkpoints, snapshots and every consumer of
the packed view cannot tell the cache exists.

Where the reference swaps immutable arrays, the kernels here update the
hot tier IN PLACE, so a migration (evict slot s, refill it with another
row) must not overlap a kernel still reading or writing s. Each store
keeps a writer-preferring gate under one condition lock:

* a lookup or update takes a reader share (after any promotion it needs),
  has its stream wait on the ``TierState``'s ready event (the migration
  that published it), launches its kernel, records an event on its stream
  and drops the share;
* a migration claims the gate (new readers wait), waits until the shares
  already taken are dropped, then, outside the lock, has its stream wait
  on the last event of every stream that launched on the tier, copies the
  evicted slots to the host (a pinned buffer; the host waits for that
  copy, and only then are the rows in the cold store), copies the promoted
  rows from the cold store into their slots through a pinned staging
  tensor, records the ready event, and publishes the new routing.

So no update is lost to a migration (every launch on the old routing is
ordered before the eviction's copy), no kernel touches a slot while its row
is replaced, and no thread waits on the host while it holds the lock
(``Condition.wait`` releases it; the eviction's copy is waited for outside
it). ``merged()`` takes a reader share too, so the cold store cannot change
under it. Every thread runs its device work on its own current stream, as
``core/streams.py`` sets out; on the CPU the events are None and the
copies complete as they are made.

``LookaheadPrefetcher`` peeks the next K batches of the (seed, iteration)-
pure stream and promotes their rows ahead of need, evicting by decayed
LFU. A cold row that beats the horizon is promoted synchronously inside
``lookup`` (counted in ``stall_lookups``), still exact.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import streams
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class CacheConfig:
    """Two-tier cache policy. Exactly one of ``hot_rows`` (rows a store
    keeps on the device) / ``hot_frac`` (a fraction of the store's rows) is
    set. ``lookahead`` is the number of queued batches the prefetcher peeks
    (0: no prefetch, every cold row a counted synchronous stall, still
    exact). ``decay`` ages the LFU counters once a prefetch round.
    ``update_retries`` bounds the reference's optimistic update swaps; an
    update here never races a migration (the gate above), so it never
    retries."""

    hot_rows: Optional[int] = None
    hot_frac: Optional[float] = None
    lookahead: int = 2
    decay: float = 0.8
    update_retries: int = 3

    def validate(self) -> "CacheConfig":
        if (self.hot_rows is None) == (self.hot_frac is None):
            raise ValueError(
                f"exactly one of hot_rows/hot_frac must be set, got "
                f"hot_rows={self.hot_rows}, hot_frac={self.hot_frac}")
        if self.hot_rows is not None and self.hot_rows < 1:
            raise ValueError(f"hot_rows must be >= 1, got {self.hot_rows}")
        if self.hot_frac is not None and not 0.0 < self.hot_frac <= 1.0:
            raise ValueError(f"hot_frac must be in (0, 1], got {self.hot_frac}")
        if self.lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {self.lookahead}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.update_retries < 0:
            raise ValueError(f"update_retries must be >= 0, got {self.update_retries}")
        return self

    def resolve_hot_rows(self, n_rows: int) -> int:
        h = (self.hot_rows if self.hot_rows is not None
             else max(1, int(round(self.hot_frac * n_rows))))
        return min(h, n_rows)

    def effective_lookahead(self, pipeline_depth: int = 1) -> int:
        """The prefetch horizon, at least the step pipeline's depth (0 stays
        0: prefetch off is respected)."""
        if self.lookahead == 0:
            return 0
        return max(self.lookahead, pipeline_depth)


@dataclass(frozen=True)
class Routing:
    """Immutable row -> hot slot map (``slot``, -1 = cold) and its inverse
    (``hot_row``, -1 = free slot); ``version`` bumps on every migration."""

    slot: np.ndarray  # (n_rows,) int32
    hot_row: np.ndarray  # (H,) int32
    version: int


@dataclass(frozen=True)
class TierState:
    """The hot arrays and the routing that indexes them, published
    together; ``ready`` (None on the CPU) completes once the migration that
    published the routing has landed on the device."""

    hot: Params  # {"table": (H, d), "acc": (H, d)}, updated in place
    routing: Routing
    ready: Optional[torch.cuda.Event] = None


@dataclass
class CacheStats:
    lookups: int = 0
    hit_rows: int = 0  # unique rows already resident at lookup
    miss_rows: int = 0  # unique rows promoted synchronously (stall path)
    stall_lookups: int = 0  # lookups that paid >= 1 synchronous promotion
    prefetch_rows: int = 0  # rows promoted ahead of need by the prefetcher
    evict_rows: int = 0
    writeback_rows: int = 0  # evictions that drained table + acc to the cold store
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    update_conflicts: int = 0  # kept for the reference's keys: always 0 here
    dropped_updates: int = 0  # kept for the reference's keys: always 0 here
    staged_lookups: int = 0  # lookups dispatched ahead of need by the step pipeline

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class _Plan:
    """A migration: rows to promote and their slots (free slots first, then
    the evicted rows' slots), rows to evict and their slots."""

    promote: np.ndarray
    dst: np.ndarray
    evict_rows: np.ndarray
    evict_slots: np.ndarray


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of ``t`` that shares no memory with it."""
    a = t.detach().to("cpu", torch.float32).numpy()
    return a.copy() if t.device.type == "cpu" else a


class CachedStore:
    """Two-tier store over one contiguous table. Row ids are LOCAL to the
    store (a shard's local ids; ``HogwildSim``'s packed global ids).
    ``lookup``/``update`` are called by trainer threads, ``prefetch`` by
    the background worker; see the module docstring for the gate."""

    def __init__(self, state: Params, cfg: CacheConfig, *, eps: float = 1e-8):
        self.cfg = cfg.validate()
        self.n_rows, self.dim = state["table"].shape
        self.device = state["table"].device
        self.eps = eps
        H = cfg.resolve_hot_rows(self.n_rows)
        self.hot_budget = H
        # hogwild-race: ok — written only by a migration, which holds the gate
        # alone; readers hold a share or the gate
        self.cold: Dict[str, np.ndarray] = {k: _host_copy(state[k]) for k in state}
        # initial placement: rows [0, H) hot (the stream's skew is on low ids)
        slot = np.full(self.n_rows, -1, np.int32)
        slot[:H] = np.arange(H, dtype=np.int32)
        hot_row = np.arange(H, dtype=np.int32)
        hot = {k: state[k][:H].detach().to(torch.float32).clone() for k in state}
        # swap-published; guarded-by-writes: _cond — every placement change
        # lands as a fresh TierState; trainers read lock-free
        self._st = TierState(hot, Routing(slot, hot_row, 0), streams.record(self.device))
        # the LFU signal: counted by lookups, aged by ``prefetch``, read by a
        # migration's plan
        self.freq = np.zeros(self.n_rows, np.float64)  # guarded-by: _cond
        # swap-published; hogwild-race: ok — prefetcher rebinds a fresh mask
        self._pinned = np.zeros(self.n_rows, bool)  # the prefetch horizon's rows
        self.stats = CacheStats()  # hogwild-race: ok — diagnostic counters
        self._row_bytes = 4 * self.dim * len(self.cold)  # f32 table + acc
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0  # guarded-by: _cond
        self._migrating = False  # guarded-by: _cond
        # guarded-by: _cond — the last event of each stream that launched on the tier
        self._uses: Dict[int, torch.cuda.Event] = {}

    # -- reads ---------------------------------------------------------------
    @property
    def state(self) -> TierState:
        return self._st

    def merged(self) -> Params:
        """The canonical full (rows, d) state as new tensors on the store's
        device: the cold store copied to the device, the hot rows scattered
        over it there. Bitwise exact: cold rows were written back on
        eviction. Holds a reader share, so no migration changes the cold
        store during its copy; concurrent updates on other streams race it
        element by element (a Hogwild read)."""
        st = self._enter(np.empty(0, np.int64))
        try:
            streams.wait(st.ready)
            occ = np.flatnonzero(st.routing.hot_row >= 0)
            slots = self._ids(occ, np.int64)
            rows = self._ids(st.routing.hot_row[occ], np.int64)
            out = {}
            for k, v in self.cold.items():
                # from pageable memory: complete when it returns
                out[k] = torch.from_numpy(v).to(self.device, copy=True)
                out[k].index_copy_(0, rows, st.hot[k].index_select(0, slots))
        finally:
            self._leave()
        return out

    def check_invariants(self) -> None:
        """Every row routed to exactly one (tier, slot); the slot and row
        maps are mutually inverse; no slot holds two rows."""
        st = self._st
        slot, hot_row = st.routing.slot, st.routing.hot_row
        hot_rows = np.flatnonzero(slot >= 0)
        if len(np.unique(slot[hot_rows])) != len(hot_rows):
            raise AssertionError("two rows share a hot slot")
        if not np.array_equal(hot_row[slot[hot_rows]], hot_rows):
            raise AssertionError("slot/hot_row maps disagree")
        occupied = np.flatnonzero(hot_row >= 0)
        if not np.array_equal(np.sort(slot[hot_row[occupied]]), np.sort(occupied)):
            raise AssertionError("occupied slot not routed back")
        if len(hot_rows) != len(occupied):
            raise AssertionError("tier population mismatch")

    # -- the gate ------------------------------------------------------------
    def _ids(self, a: np.ndarray, dtype=np.int32) -> torch.Tensor:
        """Host ids as a tensor on the store's device (through pinned
        memory, without a host wait, on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _enter(self, rows: np.ndarray) -> TierState:
        """A reader share on a state in which every row of ``rows`` is hot,
        promoting the missing ones synchronously first (the stall path)."""
        while True:
            with self._cond:
                while self._migrating:
                    self._cond.wait()
                st = self._st
                missing = rows[st.routing.slot[rows] < 0]
                if not len(missing):
                    self._readers += 1
                    return st
            self._migrate(missing, keep=rows)

    def _leave(self) -> None:
        """Drop a reader share, recording this stream's launches on the tier."""
        ev = streams.record(self.device)
        with self._cond:
            self._readers -= 1
            if ev is not None:
                self._uses[torch.cuda.current_stream(self.device).cuda_stream] = ev
            self._cond.notify_all()

    # -- hot path ------------------------------------------------------------
    def lookup(self, idx: np.ndarray, *, staged: bool = False) -> torch.Tensor:
        """Sum-pooled lookup, idx (..., m) local row ids -> (..., d): the
        embedding-bag kernel over the hot tier with ids remapped to slots;
        a cold row is promoted synchronously first (the counted stall).
        ``staged``: dispatched ahead of need by the step pipeline, on the
        stager's stream (counted in ``staged_lookups``). It takes a reader
        share and records its stream's launch like any other lookup, so a
        migration waits for it; its frequency count is left to ``count``,
        which the step that trains on the batch calls, so the LFU counts
        keep the serial order."""
        idx = np.asarray(idx)
        rows, counts = np.unique(idx, return_counts=True)
        missing = rows[self._st.routing.slot[rows] < 0]
        with self._cond:  # a staged lookup counts from the stager's thread
            if not staged:
                self.freq[rows] += counts
            self.stats.lookups += 1
            self.stats.staged_lookups += int(staged)
            self.stats.hit_rows += len(rows) - len(missing)
            if len(missing):
                self.stats.miss_rows += len(missing)
                self.stats.stall_lookups += 1
        st = self._enter(rows)
        try:
            streams.wait(st.ready)
            return embedding_bag_op(st.hot["table"], self._ids(st.routing.slot[idx]))
        finally:
            self._leave()

    def count(self, idx: np.ndarray) -> None:
        """The frequency count of a staged lookup of ``idx``, taken by the
        step that consumes it (after that step's prefetch, as ``lookup``
        counts in the serial loop)."""
        rows, counts = np.unique(np.asarray(idx), return_counts=True)
        with self._cond:
            self.freq[rows] += counts

    def update(self, idx: np.ndarray, g_pooled: torch.Tensor, lr: float) -> bool:
        """Row-sparse Adagrad on the hot tier, in place: idx (..., m) local
        row ids, g_pooled (..., d). The kernel gets the slots sorted by row
        id, so the result is bitwise the same launch on the full table.
        Returns True (the update always lands; see ``CacheConfig``)."""
        idx = np.asarray(idx)
        st = self._enter(np.unique(idx))
        try:
            streams.wait(st.ready)
            sparse_adagrad_op(st.hot["table"], st.hot["acc"], self._ids(st.routing.slot[idx]),
                              g_pooled, lr=lr, eps=self.eps, order_ids=self._ids(idx))
        finally:
            self._leave()
        return True

    # -- migration -----------------------------------------------------------
    def _plan_migration(self, need: np.ndarray, keep: np.ndarray,
                        routing: Routing) -> Optional[_Plan]:
        """Promotions for the cold rows of ``need``, evicting the
        lowest-frequency unpinned hot rows not in ``keep``. A decision only."""
        need = need[routing.slot[need] < 0]
        if not len(need):
            return None
        free = np.flatnonzero(routing.hot_row < 0).astype(np.int32)
        n_evict = max(0, len(need) - len(free))
        evict_rows = np.empty(0, np.int64)
        if n_evict:
            protect = np.zeros(self.n_rows, bool)
            protect[keep] = True
            protect[need] = True
            cand = routing.hot_row[routing.hot_row >= 0]
            cand = cand[~protect[cand]]
            if len(cand) < n_evict:
                raise ValueError(
                    f"hot tier too small: need {len(need)} promotions but only {len(cand)} "
                    f"evictable of {self.hot_budget} slots — raise hot_rows above the "
                    f"per-batch working set")
            # decayed-LFU victims, unpinned first; lexsort is stable, so ties
            # break by row id (deterministic for the sim)
            with self._cond:
                freq = self.freq[cand]
            order = np.lexsort((cand, freq, self._pinned[cand].astype(np.int8)))
            evict_rows = cand[order[:n_evict]]
        evict_slots = routing.slot[evict_rows].astype(np.int32)
        dst = np.concatenate([free[:len(need)], evict_slots])[:len(need)]
        return _Plan(need, dst.astype(np.int32), evict_rows, evict_slots)

    def _migrate(self, need: np.ndarray, keep: np.ndarray) -> int:
        """Plan and apply one migration with the gate held alone; returns
        the rows promoted. Raises (and publishes nothing) if it fails."""
        with self._cond:
            while self._migrating:
                self._cond.wait()
            self._migrating = True  # readers that arrive now wait
            while self._readers:
                self._cond.wait()
            st, uses, self._uses = self._st, list(self._uses.values()), {}
        new = st
        try:
            plan = self._plan_migration(np.asarray(need), keep, st.routing)
            if plan is not None:
                new = self._apply_migration(plan, st, uses)
        finally:
            with self._cond:
                self._st = new
                self._migrating = False
                self._cond.notify_all()
        return 0 if plan is None else len(plan.promote)

    def _apply_migration(self, plan: _Plan, st: TierState, uses) -> TierState:
        """Evicted rows drain table and acc to the cold store BEFORE their
        slots are refilled (no pending update is dropped); then the promoted
        rows land in their slots, and the new routing is returned with the
        event after the copies. Runs on the caller's stream, outside the
        lock, with every launch on the old routing ordered before it."""
        cuda = self.device.type == "cuda"
        for ev in uses:
            streams.wait(ev)
        streams.wait(st.ready)
        hot = st.hot
        if len(plan.evict_rows):
            slots = self._ids(plan.evict_slots)
            out = {k: hot[k].index_select(0, slots) for k in hot}
            if cuda:
                host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        for k, v in out.items()}
                for k in out:
                    host[k].copy_(out[k], non_blocking=True)
                streams.record(self.device).synchronize()  # the rows are on the host only now
                out = host
            for k in out:
                self.cold[k][plan.evict_rows] = out[k].numpy()
            self.stats.evict_rows += len(plan.evict_rows)
            self.stats.writeback_rows += len(plan.evict_rows)
            self.stats.bytes_d2h += len(plan.evict_rows) * self._row_bytes
        dst = self._ids(plan.dst, np.int64)
        for k in hot:
            rows = torch.from_numpy(self.cold[k][plan.promote])
            if cuda:
                rows = rows.pin_memory().to(self.device, non_blocking=True)
            hot[k].index_copy_(0, dst, rows)
        self.stats.bytes_h2d += len(plan.promote) * self._row_bytes
        slot = st.routing.slot.copy()
        hot_row = st.routing.hot_row.copy()
        slot[plan.evict_rows] = -1
        slot[plan.promote] = plan.dst
        hot_row[plan.dst] = plan.promote
        return TierState(hot, Routing(slot, hot_row, st.routing.version + 1),
                         streams.record(self.device))

    def prefetch(self, horizon: List[np.ndarray]) -> Dict[str, int]:
        """One prefetch round over the peeked batches' row sets (earliest
        first): ages the LFU counters, pins the horizon against eviction and
        promotes the misses the hot budget can take."""
        with self._cond:
            self.freq *= self.cfg.decay
        want: List[np.ndarray] = []
        seen = np.zeros(self.n_rows, bool)
        budget = self.hot_budget
        for rows in horizon:
            if rows is None or not len(rows):
                continue
            rows = np.unique(rows)
            fresh = rows[~seen[rows]]
            take = fresh[:max(0, budget - int(seen.sum()))]
            seen[take] = True
            want.append(take)
        self._pinned = seen
        if not want:
            return {"promoted": 0}
        need = np.concatenate(want)
        promoted = self._migrate(need, need)
        self.stats.prefetch_rows += promoted
        return {"promoted": promoted}

    def tensors(self) -> List[torch.Tensor]:
        """The hot tier's device tensors (to ``record_stream`` on every
        stream that launches on them)."""
        return list(self._st.hot.values())


class LookaheadPrefetcher:
    """Lookahead for one store: ``feed(j)`` returns the local row ids of the
    j-th QUEUED batch (0 = the next to train; None = end of stream).
    ``step()`` peeks the next ``lookahead`` batches and runs one prefetch
    round: the shadow thread calls it between syncs, the sim at iteration
    boundaries."""

    def __init__(self, store: CachedStore, feed: Callable[[int], Optional[np.ndarray]],
                 lookahead: Optional[int] = None):
        self.store = store
        self.feed = feed
        self.lookahead = store.cfg.lookahead if lookahead is None else lookahead

    def step(self) -> Dict[str, int]:
        if self.lookahead == 0:
            return {"promoted": 0}
        horizon = [self.feed(j) for j in range(self.lookahead)]
        return self.store.prefetch([r for r in horizon if r is not None])
