"""Plan-sharded embedding engine: the paper's embedding parameter servers,
the twin of ``repro/embeddings/shards.py``.

``plan_shards`` runs the greedy LPT planner (``table.bin_pack`` over
``table.lookup_costs``) to assign whole categorical tables to ``n_shards``
embedding PSs (paper §3.1). ``ShardPlan`` freezes that assignment plus the
derived routing; the packed (total_rows, dim) collection splits into one
contiguous (shard_rows, dim) table per PS, each with its co-located Adagrad
accumulator.

Lookups route by the plan: each shard answers one embedding-bag kernel
launch over its own features, and the pooled planes reassemble in feature
order. Backward routes the same way through the sparse-Adagrad kernel, one
launch per shard, touching only that PS's rows.

``EmbeddingShards`` is the stateful holder ``ThreadedShadowRunner`` uses,
with the reference's failure domain per PS: health, background snapshots,
fail/recover, retry-then-drop of updates aimed at a failed shard, and
incarnations. Two things differ in meaning from the reference, because the
port's sparse-Adagrad kernel updates a shard's ``table``/``acc`` IN PLACE
where the reference swaps in new immutable arrays:

* **Hogwild granularity.** In the reference two concurrent writers to one
  shard each compute a whole new state and the later swap wins, so a whole
  update is lost. Here concurrent trainers on their own streams write the
  same tensors, and updates race row by row (the paper's Hogwild). With one
  trainer the two are identical.
* **Snapshots are copies.** The reference's snapshot is an O(1) reference
  grab and recovery rebinds the live state to it. Here ``snapshot_all``
  copies each healthy shard's table and acc, on the caller's stream, into
  one of two preallocated buffers per shard and publishes the copy with its
  ready event, so a failed shard always serves a complete copy; readers
  wait on that event, and a writer waits on the events its buffer's last
  readers recorded. ``recover_shard`` copies the snapshot INTO the live
  tensors and never aliases the two. A snapshot taken while trainers write
  is consistent per element, not per moment: the port's bounded staleness.

Cached mode (``cache=``, ``embeddings/cache.py``): each healthy shard is
fronted by a ``CachedStore`` that owns its live values, and the hot path
is ``cached_lookup``/``cached_update`` (``lookup``/``try_update`` raise:
mixing the two views would fork the shard). Above the hot path nothing
changes: a snapshot is the store's ``merged()`` (new tensors, so no buffer
is reused), a failed shard loses both tiers and serves its snapshot, and
recovery builds a new store from the snapshot; ``to_packed`` goes through
``merged()``, so checkpoints cannot tell the cache exists.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import streams
from repro_torch.embeddings.cache import CacheConfig, CachedStore
from repro_torch.embeddings.table import TableSpec, bin_pack, init_tables, lookup_costs
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ShardPlan:
    """A frozen table->PS assignment plus the derived routing."""

    spec: TableSpec
    bins: Tuple[Tuple[int, ...], ...]  # feature/table ids per shard (LPT order)
    feature_shard: Tuple[int, ...]  # (F,) shard owning each feature
    feature_local_offset: Tuple[int, ...]  # (F,) row offset inside its shard
    shard_rows: Tuple[int, ...]  # packed rows per shard

    @property
    def n_shards(self) -> int:
        return len(self.bins)

    @property
    def feature_order(self) -> Tuple[int, ...]:
        """Features in shard-concatenation order (bins flattened)."""
        return tuple(f for feats in self.bins for f in feats)


def plan_shards(spec: TableSpec, n_shards: int, batch_size: int) -> ShardPlan:
    """LPT bin-pack the tables' profiled lookup costs across the PSs."""
    n_shards = max(1, min(n_shards, len(spec.sizes)))
    bins = tuple(tuple(b) for b in bin_pack(lookup_costs(spec, batch_size), n_shards))
    feature_shard = [0] * len(spec.sizes)
    feature_local_offset = [0] * len(spec.sizes)
    shard_rows = []
    for s, feats in enumerate(bins):
        off = 0
        for f in feats:
            feature_shard[f] = s
            feature_local_offset[f] = off
            off += spec.sizes[f]
        shard_rows.append(off)
    return ShardPlan(spec, bins, tuple(feature_shard), tuple(feature_local_offset),
                     tuple(shard_rows))


def shard_states(plan: ShardPlan, state: Params) -> List[Params]:
    """Split a packed {"table", "acc"} state into per-shard states (each shard
    concatenates its tables' global row ranges in bin order). New tensors."""
    goff = plan.spec.offsets
    out = []
    for feats in plan.bins:
        parts = [(int(goff[f]), int(goff[f]) + plan.spec.sizes[f]) for f in feats]
        out.append({k: torch.cat([state[k][a:b] for a, b in parts]) for k in state})
    return out


def packed_state(plan: ShardPlan, states: List[Params]) -> Params:
    """Inverse of ``shard_states``: reassemble the global packed state."""
    parts = {k: [None] * len(plan.spec.sizes) for k in states[0]}
    for f in range(len(plan.spec.sizes)):
        s, loff = plan.feature_shard[f], plan.feature_local_offset[f]
        for k in parts:
            parts[k][f] = states[s][k][loff:loff + plan.spec.sizes[f]]
    return {k: torch.cat(v) for k, v in parts.items()}


@functools.lru_cache(maxsize=None)
def _routing(plan: ShardPlan, device: torch.device):
    """Per-shard (feature ids, local offsets) and the inverse feature
    permutation, as tensors on ``device``, built once per plan and device."""
    per_shard = [
        (torch.as_tensor(feats, dtype=torch.long, device=device),
         torch.as_tensor([plan.feature_local_offset[f] for f in feats], dtype=torch.int32,
                         device=device))
        for feats in plan.bins]
    order = torch.as_tensor(plan.feature_order, dtype=torch.long)
    inv = torch.argsort(order).to(device)
    return per_shard, inv


def _route(plan: ShardPlan, s: int, idx: torch.Tensor) -> torch.Tensor:
    """Shard s's slice of a (B, F, m) index batch, in LOCAL row ids."""
    feats, offs = _routing(plan, idx.device)[0][s]
    return idx.index_select(1, feats) + offs[None, :, None]


def _route_np(plan: ShardPlan, s: int, idx: np.ndarray) -> np.ndarray:
    """``_route`` on the host: the cache and its prefetcher index numpy
    routing tables, so the ids stay off the device."""
    feats = np.asarray(plan.bins[s])
    offs = np.asarray([plan.feature_local_offset[f] for f in plan.bins[s]], np.int32)
    return np.take(idx, feats, axis=1) + offs[None, :, None]


def assemble(plan: ShardPlan, outs: List[torch.Tensor]) -> torch.Tensor:
    """Per-shard pooled planes (bins order) -> (B, F, dim) in feature order."""
    pooled = torch.cat(outs, dim=1)
    return pooled.index_select(1, _routing(plan, pooled.device)[1])


def shard_lookup(plan: ShardPlan, tables: Tuple[torch.Tensor, ...],
                 idx: torch.Tensor) -> torch.Tensor:
    """Plan-routed sum-pooled lookup. idx: (B, F, m) LOCAL-per-feature ids
    (as the data pipeline makes them) -> (B, F, dim). One kernel launch per
    shard."""
    return assemble(plan, [embedding_bag_op(tables[s], _route(plan, s, idx))
                           for s in range(plan.n_shards)])


def shard_update(plan: ShardPlan, s: int, state_s: Params, idx: torch.Tensor,
                 g_pooled: torch.Tensor, lr: float, eps: float = 1e-8) -> Params:
    """Sparse-Adagrad backward for ONE shard, in place on ``state_s``:
    touches only this PS's rows, so per-shard updates are independent
    Hogwild writes. Returns ``state_s``."""
    m, d = idx.shape[-1], g_pooled.shape[-1]
    loc = _route(plan, s, idx).reshape(-1, m)
    feats = _routing(plan, g_pooled.device)[0][s][0]
    g = g_pooled.index_select(1, feats).reshape(-1, d)
    sparse_adagrad_op(state_s["table"], state_s["acc"], loc, g, lr=lr, eps=eps)
    return state_s


@dataclass(frozen=True)
class ShardRetryPolicy:
    """Routing policy for updates aimed at a failed shard: retry with
    backoff inside a bounded budget, then drop (bounded staleness beats an
    unbounded stall: the surviving shards must never wait)."""

    retries: int = 2  # attempts AFTER the first
    backoff_s: float = 0.005  # sleep before each retry (doubles per retry)
    timeout_s: float = 0.05  # hard wall-clock budget for the whole attempt

    def validate(self) -> "ShardRetryPolicy":
        if self.retries < 0 or self.backoff_s < 0 or self.timeout_s <= 0:
            raise ValueError(
                f"need retries >= 0, backoff_s >= 0, timeout_s > 0; got "
                f"retries={self.retries}, backoff_s={self.backoff_s}, "
                f"timeout_s={self.timeout_s}")
        return self


@dataclass(frozen=True)
class ShardEvent:
    """One PS failure-domain transition (``EmbeddingShards.events``)."""

    kind: str  # "ps_fail" | "ps_recover"
    shard: int
    t: float  # time.perf_counter domain (same clock as supervision events)
    reason: str = ""


class EmbeddingShards:
    """Holder of the per-PS Hogwild states (ThreadedShadowRunner's embedding
    substrate). ``states[s]`` is shard s's live {"table", "acc"}, updated in
    place by concurrent trainers (see the module docstring).

    Failure domain: ``health[s]`` marks a live shard; ``fail_shard`` loses
    the live state, after which ``lookup_shard`` serves the latest
    background snapshot (a stale read, counted in ``stale_lookups``) and
    ``try_update`` retries then drops writes (counted in
    ``dropped_updates``). ``recover_shard`` copies the snapshot back into
    the live tensors and the shard rejoins the plan. The constructor seeds
    the generation-0 snapshots, so recovery is always possible.

    Thread model: trainers call ``lookup``/``try_update`` (cached:
    ``cached_lookup``/``cached_update``) without a lock; health, snapshot
    and incarnation transitions take ``_lock``, and device work never runs
    under it."""

    def __init__(self, plan: ShardPlan, states: List[Params],
                 retry: Optional[ShardRetryPolicy] = None,
                 cache: Optional[CacheConfig] = None):
        self.plan = plan
        self.retry = (retry or ShardRetryPolicy()).validate()
        self.cache = cache.validate() if cache is not None else None
        n = plan.n_shards
        self.device = states[0]["table"].device
        self.health: List[bool] = [True] * n  # guarded-by-writes: _lock
        # every stream that reads or writes the shards (share_with)
        # hogwild-race: ok — bound once by share_with before any thread starts
        self._streams: List = []
        if self.cache is None:
            # swap-published: elements; hogwild-race: ok — the slots are never
            # rebound; the kernels update their tensors in place (Hogwild)
            self.states: List[Optional[Params]] = list(states)
            # swap-published: elements; guarded-by-writes: _lock — whole-store
            # incarnations swapped on fail/recover; lock-free reads
            self.stores: List[Optional[CachedStore]] = [None] * n
            # two snapshot buffers per shard; snapshots[s] publishes the
            # complete one with its ready event, the other takes the next copy
            self._buffers = [[{k: v.clone() for k, v in st.items()},
                              {k: torch.empty_like(v) for k, v in st.items()}] for st in states]
        else:
            # the stores own the live values; states[] stays None so an
            # uncached access fails instead of reading a fork
            self.states = [None] * n
            self.stores = [CachedStore(st, self.cache) for st in states]
            self._buffers = [[dict(st)] for st in states]  # generation 0: the initial states
        ready = streams.record(self.device)
        # swap-published: elements; guarded-by-writes: _lock
        self.snapshots: List[streams.Published] = [
            streams.Published(bufs[0], ready) for bufs in self._buffers]
        self._snap_slot = [0] * n  # guarded-by: _lock — moves with snapshots[s]
        # per shard and buffer: the last event each reading stream recorded
        # after it read the buffer; a snapshot waits on them before
        # overwriting the buffer
        # guarded-by: _lock
        self._readers: List[List[Dict[int, torch.cuda.Event]]] = [[{}, {}] for _ in range(n)]
        # hogwild-race: ok — lossy-by-design failure counters (under-count only)
        self.dropped_updates: List[int] = [0] * n
        self.stale_lookups: List[int] = [0] * n  # hogwild-race: ok — same lossy contract
        self.events: List[ShardEvent] = []  # guarded-by-writes: _lock
        self.failed_at: Dict[int, float] = {}  # guarded-by-writes: _lock — shard -> fail time
        # bumped on BOTH fail and recover: a snapshot copied across a
        # transition is not published
        self.incarnations: List[int] = [0] * n  # guarded-by-writes: _lock
        self._lock = threading.Lock()
        self._snapshot_gate = threading.Lock()  # one snapshot_all at a time

    @classmethod
    def init(cls, plan: ShardPlan, gen: torch.Generator, retry: Optional[ShardRetryPolicy] = None,
             cache=None, device=None) -> "EmbeddingShards":
        # Seed-identical to the single-table engine: init the packed
        # collection once (drawn from ``gen``), then split by the plan.
        return cls(plan, shard_states(plan, init_tables(plan.spec, gen, device=device)),
                   retry=retry, cache=cache)

    def share_with(self, stream_list) -> None:
        """Record every shard tensor (a cached shard's hot tier) on each of
        ``stream_list``'s streams (the threads that read and write them),
        once at the start of a run; a store rebuilt by ``recover_shard`` is
        recorded on the same streams."""
        self._streams = [st for st in stream_list if st is not None]
        tensors = [t for st in self.states if st is not None for t in st.values()]
        tensors += [t for store in self.stores if store is not None for t in store.tensors()]
        tensors += [t for bufs in self._buffers for b in bufs for t in b.values()]
        self._share(tensors)

    def _share(self, tensors) -> None:
        for stream in self._streams:
            for t in tensors:
                t.record_stream(stream)

    # -- snapshot readers ----------------------------------------------------
    def _read_snapshot(self, s: int) -> Tuple[Params, int]:
        with self._lock:
            pub, slot = self.snapshots[s], self._snap_slot[s]
        return streams.consume(pub), slot

    def _done_reading(self, s: int, slot: int) -> None:
        ev = streams.record(self.device)
        if ev is not None:
            with self._lock:
                self._readers[s][slot][torch.cuda.current_stream().cuda_stream] = ev

    # -- hot path ------------------------------------------------------------
    def _stale_lookup(self, s: int, idx: torch.Tensor) -> torch.Tensor:
        """A failed shard answers from its snapshot (the bounded-staleness
        read, counted in ``stale_lookups``)."""
        self.stale_lookups[s] += 1
        snap, slot = self._read_snapshot(s)
        out = embedding_bag_op(snap["table"], _route(self.plan, s, idx))
        self._done_reading(s, slot)
        return out

    def incarnation(self, s: int) -> int:
        """Failure-domain token for shard ``s``: the step pipeline captures
        it at staging and drains the staged value on any mismatch."""
        return self.incarnations[s]

    def lookup_shard(self, s: int, idx, *, staged: bool = False) -> torch.Tensor:
        """ONE shard's pooled plane for the full (B, F, m) batch, callable
        alone so the step pipeline (``core/pipeline.py``) can stage single
        shards ahead of need. ``idx``: host ids (numpy) in cached mode, a
        tensor on the shards' device otherwise. A healthy cached shard
        answers from its hot tier (``staged`` is counted there), a healthy
        uncached one from its live table, a failed one from its snapshot."""
        if self.cache is not None:
            idx = np.asarray(idx)
            store = self.stores[s]
            if store is not None and self.health[s]:
                return store.lookup(_route_np(self.plan, s, idx), staged=staged)
            return self._stale_lookup(s, torch.from_numpy(idx).to(self.device))
        if self.health[s]:
            return embedding_bag_op(self.states[s]["table"], _route(self.plan, s, idx))
        return self._stale_lookup(s, idx)

    def count_staged(self, s: int, idx: np.ndarray) -> None:
        """A cached shard's frequency count of a staged ``lookup_shard``,
        taken by the step that consumes it (``CachedStore.count``)."""
        store = self.stores[s]
        if store is not None:
            store.count(_route_np(self.plan, s, np.asarray(idx)))

    def assemble(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """Per-shard planes (bins order) -> (B, F, dim) in feature order, so
        staged and serial shard planes compose freely."""
        return assemble(self.plan, outs)

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """``shard_lookup`` over the live (or, for a failed shard, snapshot)
        tables: idx (B, F, m) -> (B, F, dim)."""
        if self.cache is not None:
            raise RuntimeError("cached mode: use cached_lookup (lookup would read the "
                               "full-table copy, not the live hot tier)")
        return self.assemble([self.lookup_shard(s, idx) for s in range(self.plan.n_shards)])

    # -- cached hot path -----------------------------------------------------
    def cached_lookup(self, idx: np.ndarray) -> torch.Tensor:
        """``lookup`` through the per-shard caches: idx (B, F, m) host ids,
        local per feature -> (B, F, dim), bitwise ``shard_lookup``. A failed
        shard answers from its snapshot."""
        if self.cache is None:
            raise RuntimeError("cached_lookup requires cache= at init")
        return self.assemble([self.lookup_shard(s, idx) for s in range(self.plan.n_shards)])

    def cached_update(self, s: int, idx: np.ndarray, g_pooled: torch.Tensor, lr: float,
                      eps: float = 1e-8) -> bool:
        """One Hogwild write at shard ``s`` through its cache, with
        ``try_update``'s ladder (retry against a failed shard, then a counted
        drop). idx is the full (B, F, m) batch on the host; shard ``s``'s
        features and gradient planes are routed as ``shard_update`` routes
        them."""
        if self.cache is None:
            raise RuntimeError("cached_update requires cache= at init")
        idx = np.asarray(idx)
        m, d = idx.shape[-1], g_pooled.shape[-1]
        loc = _route_np(self.plan, s, idx).reshape(-1, m)
        feats = _routing(self.plan, g_pooled.device)[0][s][0]
        g = g_pooled.index_select(1, feats).reshape(-1, d)
        retry = self.retry
        deadline = time.perf_counter() + retry.timeout_s
        backoff = retry.backoff_s
        for attempt in range(retry.retries + 1):
            store = self.stores[s]
            if self.health[s] and store is not None:
                store.update(loc, g, lr)
                if self.health[s]:
                    return True
            if attempt == retry.retries or time.perf_counter() >= deadline:
                break
            time.sleep(min(backoff, max(deadline - time.perf_counter(), 0.0)))
            backoff *= 2.0
        self.dropped_updates[s] += 1
        return False

    def cache_stats(self) -> Dict[str, int]:
        """``CacheStats`` summed over the live stores."""
        total: Dict[str, int] = {}
        for store in self.stores:
            if store is not None:
                for k, v in store.stats.as_dict().items():
                    total[k] = total.get(k, 0) + v
        return total

    def try_update(self, s: int, fn, *args) -> bool:
        """Route one Hogwild write at shard ``s``: ``fn(state, *args)``
        updates the live state in place. Against a healthy shard this is the
        plain lock-free write. Against a failed shard it retries with
        exponential backoff inside ``ShardRetryPolicy``'s budget, then drops
        the update (returns False; the drop is the measured staleness cost).
        A write that lands just as the shard fails went into the lost state,
        which recovery overwrites, and counts as not landed."""
        if self.cache is not None:
            raise RuntimeError("cached mode: use cached_update (try_update would write the "
                               "full-table copy, not the live hot tier)")
        retry = self.retry
        deadline = time.perf_counter() + retry.timeout_s
        backoff = retry.backoff_s
        for attempt in range(retry.retries + 1):
            if self.health[s]:
                fn(self.states[s], *args)
                if self.health[s]:
                    return True
            if attempt == retry.retries or time.perf_counter() >= deadline:
                break
            time.sleep(min(backoff, max(deadline - time.perf_counter(), 0.0)))
            backoff *= 2.0
        self.dropped_updates[s] += 1
        return False

    # -- failure-domain transitions ------------------------------------------
    def snapshot_all(self, reason: str = "") -> None:
        """Copy every healthy shard into its spare snapshot buffer on the
        current stream and publish the copy with its ready event. The shadow
        thread calls this every few rounds. A shard that fails or recovers
        while its copy is in flight keeps its previous snapshot."""
        if not self._snapshot_gate.acquire(blocking=False):
            return  # another thread is mid-snapshot
        if self.cache is not None:
            try:
                self._snapshot_cached()
            finally:
                self._snapshot_gate.release()
            return
        try:
            with self._lock:
                todo = []
                for s in range(self.plan.n_shards):
                    if self.health[s]:
                        slot = 1 - self._snap_slot[s]
                        todo.append((s, slot, self.incarnations[s],
                                     list(self._readers[s][slot].values())))
                        self._readers[s][slot] = {}
            for s, slot, inc, readers in todo:
                for ev in readers:
                    streams.wait(ev)
                buf = self._buffers[s][slot]
                for k, v in self.states[s].items():
                    buf[k].copy_(v)
                ready = streams.record(self.device)
                with self._lock:
                    if self.health[s] and self.incarnations[s] == inc:
                        self.snapshots[s] = streams.Published(buf, ready)
                        self._snap_slot[s] = slot
        finally:
            self._snapshot_gate.release()

    def _snapshot_cached(self) -> None:
        """Cached mode: each live store's ``merged()``, new tensors, published
        only if the same store is still live (a fail or recover during the
        merge would make it a snapshot of a dead incarnation)."""
        with self._lock:
            live = [(s, self.stores[s]) for s in range(self.plan.n_shards)
                    if self.health[s] and self.stores[s] is not None]
        for s, store in live:
            snap = store.merged()
            ready = streams.record(self.device)
            with self._lock:
                if self.health[s] and self.stores[s] is store:
                    self.snapshots[s] = streams.Published(snap, ready)

    def fail_shard(self, s: int, reason: str = "") -> None:
        """PS ``s`` dies: its live state is LOST (recovery overwrites it).
        Lookups fall back to the snapshot, updates start dropping after
        retries."""
        with self._lock:
            if not self.health[s]:
                return  # already down
            self.health[s] = False
            self.stores[s] = None  # cached mode: both tiers die with the PS
            self.incarnations[s] += 1
            self.failed_at[s] = time.perf_counter()
            self.events.append(ShardEvent("ps_fail", s, self.failed_at[s], reason))

    def recover_shard(self, s: int, reason: str = "") -> None:
        """Copy shard ``s``'s latest snapshot into its live tensors and
        rejoin the routing plan. The copy is complete on the device before
        the shard serves again. The delta between the snapshot and the
        pre-failure live state (plus the updates dropped while down) is the
        bounded-staleness cost."""
        with self._lock:
            if self.health[s]:
                return  # already up
        snap, slot = self._read_snapshot(s)
        store = None
        if self.cache is not None:
            # a new store from the canonical snapshot: placement restarts
            # from the default and the prefetcher re-derives it
            store = CachedStore(snap, self.cache)
            self._share(store.tensors())
        else:
            for k, v in self.states[s].items():
                v.copy_(snap[k])
        self._done_reading(s, slot)
        done = streams.record(self.device)
        if done is not None:
            done.synchronize()  # rare, and off every trainer's path
        with self._lock:
            if self.health[s]:
                return  # a concurrent recovery beat us to it
            self.stores[s] = store
            self.health[s] = True
            self.incarnations[s] += 1
            self.failed_at.pop(s, None)
            self.events.append(ShardEvent("ps_recover", s, time.perf_counter(), reason))

    def down_shards(self) -> List[int]:
        return [s for s in range(self.plan.n_shards) if not self.health[s]]

    def to_packed(self) -> Params:
        """The packed {"table", "acc"} view (new tensors). A failed shard
        contributes its snapshot (the best surviving copy), a cached one its
        store's ``merged()``."""
        states, read = [], []
        for s in range(self.plan.n_shards):
            store = self.stores[s]
            if self.health[s] and store is not None:
                states.append(store.merged())
            elif self.health[s] and self.cache is None:
                states.append(self.states[s])
            else:
                snap, slot = self._read_snapshot(s)
                states.append(snap)
                read.append((s, slot))
        out = packed_state(self.plan, states)
        for s, slot in read:
            self._done_reading(s, slot)
        return out
