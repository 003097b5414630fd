"""The two training runners, twins of ``HogwildSim`` and
``ThreadedShadowRunner`` in ``repro/core/runners.py``.

``HogwildSim`` simulates n trainers x m Hogwild worker threads over one
shared packed embedding table and per-trainer dense replicas. Hogwild
staleness: all m thread-gradients of an iteration come from the SAME replica
snapshot and are then applied one after another through the optimizer.
Background sync follows shadow clocks with launch-snapshot / delayed-landing
semantics, or a fixed-rate barrier, and the ``SyncAlgorithm`` fetched from
``core.algorithms`` owns what a sync does.

Each iteration launches the embedding-bag kernel once (the lookup of every
trainer's and thread's bags from the pre-update tables), then the dense
forward/backward and optimizer steps in plain torch, then the sparse-Adagrad
kernel once with every thread's gradient. A landing sync is the algorithm's
kernel launch over the flat ``(R, n_rows, 128)`` replica buffer
(``engine="flat"``, the default): EASGD's round, MA's and BMUF's pull-back
toward the launch-time mean, Gossip's pair round; ``engine="pytree"`` runs
the tree oracle.

Elastic membership (``membership=`` or ``schedule=``): the buffers are
allocated at the capacity ``R_max``, and join/leave/fail only flip the live
mask. Dead slots are still computed, which keeps every shape fixed, but
contribute nothing: ``torch.where`` keeps their weights and optimizer state
and their embedding gradients are zeroed (a zero-gradient sparse-Adagrad
row update leaves the row and its accumulator bitwise unchanged). Launches
and landings take the live mask, so the sync kernels read and write only
live rows. Without either option the sim runs the fixed-R path unchanged.

``ThreadedShadowRunner`` (below) is the paper's Algorithm 1 with real
threads: trainer threads race on plan-sharded embedding PSs while a
background shadow thread syncs the dense replicas, each thread on its own
CUDA stream.

The tiered embedding cache (``cache=``, ``embeddings/cache.py``) runs in
both: the sim puts its packed table behind one ``CachedStore`` for a run,
the threaded runner one per PS. ``HogwildSim.save_state``/``load_state``
write and read the JAX package's checkpoint format (``checkpoint/``).

Step pipelining (``pipeline=``, ``core/pipeline.py``) runs in both: a
stager thread on its own CUDA stream looks up batch k+1 while batch k's
dense pass runs, behind a hazard check that keeps the trajectory bitwise
the serial one. The sim takes a scripted or closed-loop mode trace
(``mode_schedule=``, ``core/modeswitch.py``) and a ``StragglerSchedule``
(``core/scheduler.py``) as its membership schedule; the threaded runner
takes the live straggler policy and mode controller.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import tree as T
from repro_torch.core import algorithms, streams
from repro_torch.core import sync as S
from repro_torch.core.elp import EPSMeter, SlotEPS, median_eps
from repro_torch.core.flatspace import FlatSpace
from repro_torch.core.membership import FaultSpec, Membership, MembershipSchedule
from repro_torch.core.modeswitch import ModeController, ModeDecision, ModeSchedule
from repro_torch.core.pipeline import PipelineConfig, PipelineStats, StepPipeline
from repro_torch.core.scheduler import StragglerPolicy
from repro_torch.core.supervision import Supervisor, SupervisorConfig
from repro_torch.data import ctr
from repro_torch.embeddings import shards as emb_shards
from repro_torch.embeddings import table as emb
from repro_torch.embeddings.cache import CacheConfig, CachedStore
from repro_torch.kernels import backend
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dlrm
from repro_torch.optim import Optimizer

Tree = Any


def _dense_flatspace(cfg) -> FlatSpace:
    """Layout of the DLRM dense replica space (from a throwaway CPU init)."""
    return FlatSpace.from_tree(dlrm.init_dense(cfg, torch.Generator()))


def _stack(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


@dataclass
class SimState:
    # Dense replicas: a tree stack with leading R (engine="pytree") or a
    # persistent (R, n_rows, 128) fp32 flat buffer (engine="flat").
    w_stack: Tree
    opt_stack: Tree
    emb_state: Dict[str, torch.Tensor]  # shared {"table", "acc"}
    algo_state: Any  # owned by the SyncAlgorithm (EASGD: the sync-PS copy)
    step: int


class HogwildSim:
    def __init__(
        self,
        cfg,  # DLRMConfig
        sync_cfg: S.SyncConfig,
        *,
        n_trainers: int,
        n_threads: int,
        batch_size: int,
        optimizer: Optimizer,
        emb_lr: float = 0.05,
        seed: int = 0,
        membership=None,
        schedule=None,
        cache=None,
        pipeline: Optional[PipelineConfig] = None,
        mode_schedule=None,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        # Runtime mode switching: a deterministic per-iteration mode trace
        # (scripted [(iteration, mode)] switch points or a closed-loop
        # ControllerModeSchedule) moves the whole cohort between shadow and
        # fixed_rate at iteration boundaries, with the handoff in run().
        # Without one the sim runs the single-mode path unchanged.
        if mode_schedule is not None and not isinstance(mode_schedule, ModeSchedule):
            mode_schedule = ModeSchedule(mode_schedule, start_mode=sync_cfg.mode)
        if mode_schedule is not None and mode_schedule.start_mode != sync_cfg.mode:
            raise ValueError(
                f"mode_schedule starts in {mode_schedule.start_mode!r} but sync_cfg.mode is "
                f"{sync_cfg.mode!r}; construct them to agree")
        self.mode_schedule = mode_schedule
        # Step pipelining: a StepPipeline stages batch k+1's lookup while
        # batch k's dense pass runs, hazard-checked over the peeked stream.
        self.pipeline = pipeline.validate() if pipeline is not None else None
        # Tiered embedding cache: the packed table moves behind one
        # CachedStore for a run; merged() gives the canonical tables back at
        # its end, so save, evaluation and resume never see the cache.
        self.cache: Optional[CacheConfig] = cache.validate() if cache is not None else None
        self.cfg = cfg
        self.sync_cfg = sync_cfg.validate()
        self.engine = sync_cfg.engine
        self.algo = algorithms.get(sync_cfg.algo)
        # Elastic membership: buffers at capacity R_max; join/leave/fail flip
        # the live mask only. Without membership= or schedule= the sim runs
        # the fixed-R path.
        self._elastic = membership is not None or schedule is not None
        if schedule is not None and not isinstance(schedule, MembershipSchedule):
            schedule = MembershipSchedule(schedule)
        self.schedule = schedule
        if membership is None:
            cap = n_trainers
            if schedule is not None:
                cap = max(cap, schedule.max_slot() + 1)
            membership = Membership(n_trainers, R_max=cap)
        if membership.R_max < n_trainers:
            raise ValueError(f"membership capacity {membership.R_max} < n_trainers {n_trainers}")
        self.membership = membership
        self.R, self.M, self.B = membership.R_max, n_threads, batch_size
        self.opt = optimizer
        self.emb_lr = emb_lr
        self.seed = seed
        self.spec = emb.spec_from_config(cfg)
        self.teacher = ctr.make_teacher(cfg, seed=seed + 777, device=self.device)
        self.flat = _dense_flatspace(cfg) if self.engine == "flat" else None

    # -- one training iteration ------------------------------------------------
    def _dense_core(self, w: Tree, opt_state: Tree, pooled: torch.Tensor, batch,
                    active: Optional[np.ndarray] = None):
        """Everything downstream of the lookup. ``w``: the (R, ...) replica
        stack; pooled: (R, M, B, F, d). M thread-gradients per trainer from the
        SAME weights, applied one after another. With ``active`` (elastic
        runs) dead slots keep their weights and optimizer state, their
        embedding gradients are zeroed, and the loss is the per-replica
        vector (R,); otherwise it is the cohort mean."""
        R, M = self.R, self.M
        w_old, opt_old = w, opt_state
        w_threads = T.map(lambda x: x.unsqueeze(1).expand((R, M) + tuple(x.shape[1:])), w)
        loss, g_w, g_pooled = dlrm.dense_loss_and_grads(
            w_threads, batch["dense"], pooled, batch["labels"])  # loss: (R, M)
        for j in range(M):
            w, opt_state = self.opt.update(w, opt_state, T.map(lambda g: g[:, j], g_w))
        if active is None:
            return w, opt_state, loss.mean(1).mean(0), g_pooled
        live = torch.as_tensor(active, dtype=torch.bool, device=g_pooled.device)

        def keep(new, old):
            return torch.where(live.reshape((R,) + (1,) * (old.dim() - 1)), new, old)

        w = T.map(keep, w, w_old)
        opt_state = T.map(keep, opt_state, opt_old)
        g_pooled = torch.where(live.reshape((R, 1, 1, 1, 1)), g_pooled, 0.0)
        return w, opt_state, loss.mean(1), g_pooled

    def _train_iter(self, st: SimState, batch, active: Optional[np.ndarray] = None,
                    store: Optional[CachedStore] = None, gids: Optional[np.ndarray] = None,
                    pooled: Optional[torch.Tensor] = None,
                    on_dense: Optional[Callable[[], None]] = None):
        """One iteration: lookup, dense pass, sparse update. With ``store``
        (a cached run) the lookup and the update go through the hot tier
        over ``gids``, the batch's packed global ids on the host: the same
        two kernel launches, bitwise. ``pooled``: a lookup the step pipeline
        staged (None: look up here; a staged cached lookup's frequency count
        is taken here); ``on_dense`` runs after the dense dispatch and before
        the sparse update (the pipeline's ``stage``)."""
        cfg, spec = self.cfg, self.spec
        F, m, d = cfg.n_sparse_features, cfg.multi_hot, cfg.embedding_dim
        idx = batch["sparse"].reshape(-1, F, m)
        if pooled is None:
            pooled = emb.lookup(st.emb_state, spec, idx) if store is None else store.lookup(gids)
        elif store is not None:
            store.count(gids)
        pooled = pooled.reshape(self.R, self.M, self.B, F, d)
        w = self.flat.unpack_stack(st.w_stack) if self.engine == "flat" else st.w_stack
        w, st.opt_stack, loss, g_pooled = self._dense_core(w, st.opt_stack, pooled, batch,
                                                           active)
        st.w_stack = self.flat.pack_stack(w) if self.engine == "flat" else w
        if on_dense is not None:
            on_dense()
        # Hogwild on the single embedding copy: one fused, in-place
        # scatter-Adagrad launch with every trainer's and thread's gradient.
        if store is None:
            emb.sparse_adagrad_update_fused(st.emb_state, spec, idx,
                                            g_pooled.reshape(-1, F, d), self.emb_lr)
        else:  # the same (R*M*B*F, m) / (R*M*B*F, d) flattening
            store.update(gids.reshape(-1, m), g_pooled.reshape(-1, d), self.emb_lr)
        return loss

    # -- state --------------------------------------------------------------
    def init_state(self) -> SimState:
        gen = torch.Generator().manual_seed(self.seed)
        w0 = dlrm.init_dense(self.cfg, gen, device=self.device)
        return self._state_from(w0, emb.init_tables(self.spec, gen, device=self.device))

    def _state_from(self, w0: Tree, emb_state: Dict[str, torch.Tensor]) -> SimState:
        """Step-0 state of every replica at ``w0``, with ``emb_state``."""
        opt0 = self.opt.init(w0)
        opt_stack = T.map(lambda x: _stack(x, self.R), opt0)
        if self.engine == "flat":
            fs = self.flat
            w_stack = fs.broadcast(w0, self.R)  # packed ONCE
            algo_state = self.algo.init_state_flat(fs.pack(w0), self.sync_cfg, fs)
        else:
            w_stack = T.map(lambda x: _stack(x, self.R), w0)
            algo_state = self.algo.init_state(w0, self.sync_cfg)
        return SimState(w_stack, opt_stack, emb_state, algo_state, 0)

    def make_batch(self, it: int) -> Dict[str, torch.Tensor]:
        """One-pass stream: R*M distinct shards per iteration, as (R, M, B, ...)."""
        b = ctr.gen_batch(self.cfg, self.teacher, self.seed, it, self.B * self.R * self.M)
        return {k: v.reshape(self.R, self.M, self.B, *v.shape[1:]) for k, v in b.items()}

    # -- sync scheduling ----------------------------------------------------
    def _shadow_schedule(self, t: int) -> np.ndarray:
        """mask[i]: replica i's shadow clock fires at iteration t (staggered)."""
        gap = self.sync_cfg.gap
        offs = (np.arange(self.R) * gap) // max(self.R, 1)
        return ((t + offs) % gap) == 0

    def _launch_snapshot(self, st: SimState, mask: np.ndarray,
                         active: Optional[np.ndarray] = None) -> Any:
        """State captured when a background sync launches (lands ``delay``
        later): the algorithm's compact form on the flat engine (a fired-rows
        gather for EASGD and Gossip, the mean plane for MA and BMUF), a deep
        copy of the stack on the pytree engine. ``active`` is the membership
        mask at launch: a dead slot is never snapshotted."""
        if self.engine == "flat":
            return self.algo.launch_snapshot_flat(st.w_stack, mask, self.sync_cfg, self.flat,
                                                  st.algo_state, active=active)
        return T.map(torch.clone, st.w_stack)

    def _apply_sync(self, st: SimState, snap, mask, active=None, launch_active=None) -> SimState:
        """Land one sync. ``snap=None``: fixed rate, sync against the current
        state; ``mask=None``: every replica fired; ``active`` /
        ``launch_active``: the membership masks at landing / launch (None
        when the run is not elastic)."""
        if self.engine == "flat":
            st.w_stack, st.algo_state = self.algo.land_flat(
                st.w_stack, st.algo_state, snap, mask, self.sync_cfg, self.flat, active=active)
        elif active is None:
            st.w_stack, st.algo_state = self.algo.land(
                st.w_stack, st.algo_state, snap, mask, self.sync_cfg)
        else:
            st.w_stack, st.algo_state = self.algo.land_elastic(
                st.w_stack, st.algo_state, snap, mask, active, self.sync_cfg,
                launch_active=launch_active)
        return st

    def _apply_membership_event(self, st: SimState, kind: str, slot: int,
                                reason: str = "") -> SimState:
        """One schedule transition, at an iteration boundary. A join
        bootstraps through the algorithm's ``on_join`` hook (the live mean,
        or EASGD's PS plane) with a fresh optimizer slot; a leave or fail
        dispatches ``on_leave``. Nothing reallocates. ``reason`` goes into
        the membership log (a ``StragglerSchedule`` demotion's provenance)."""
        sc, fs = self.sync_cfg, self.flat
        if kind in ("fail", "leave"):
            getattr(self.membership, kind)(slot, reason=reason)
            if self.engine == "flat":
                st.algo_state = self.algo.on_leave_flat(st.algo_state, slot, sc, fs)
            else:
                st.algo_state = self.algo.on_leave(st.algo_state, slot, sc)
            return st
        if kind != "join":
            raise ValueError(f"unknown membership event kind {kind!r}")
        donors = self.membership.active_mask()  # before the join
        self.membership.join(slot, reason=reason)
        if donors.any():  # no live donors: keep the slot's current weights
            if self.engine == "flat":
                st.w_stack, st.algo_state = self.algo.on_join_flat(
                    st.w_stack, slot, st.algo_state, donors, sc, fs)
            else:
                st.w_stack, st.algo_state = self.algo.on_join(
                    st.w_stack, slot, st.algo_state, donors, sc)
        # a fresh optimizer state for the slot (every optimizer's init is
        # made from the parameters' shapes alone)
        st.opt_stack = S.tree_set(st.opt_stack, slot,
                                  self.opt.init(self.replica_params(st, slot)))
        self.membership.activate(slot)
        return st

    def _stager(self, st: SimState, store: Optional[CachedStore], end: int,
                gids_of: Callable[[int], np.ndarray]):
        """The step pipeline of one run, and the stager's CUDA stream (None on
        the CPU). The stager makes batch ``it`` with ``make_batch`` on its
        own stream and takes its rows from the ids the step will look up and
        update: the batch's own ids uncached, the host ids ``gids_of(it)``
        cached (the memo the prefetch horizon reads, so each batch's ids are
        drawn once). It looks the batch up on its stream after waiting on the
        event ``make_ctx`` recorded on this thread's stream at ``stage``
        time; the batch and the pooled plane go back as
        ``streams.Published``."""
        dev, spec = self.device, self.spec
        F, m = self.cfg.n_sparse_features, self.cfg.multi_hot
        stream = streams.new_stream(dev)
        if stream is not None:  # the tables (hot tier) are read on its stream
            held = store.tensors() if store is not None else list(st.emb_state.values())
            for x in held:
                x.record_stream(stream)

        def prepare(it: int) -> Dict[str, Any]:
            with streams.on(stream):
                b = self.make_batch(it)
                ready = streams.record(dev)
                gids = (gids_of(it) if store is not None else
                        b["sparse"].cpu().numpy().reshape(-1, F, m) + spec.offsets[None, :, None])
            return {"rows": [np.unique(gids)], "batch": streams.Published(b, ready),
                    "gids": gids}

        def stage_fn(s: int, it: int, prep: Dict[str, Any], ctx) -> streams.Published:
            state, fence = ctx
            with streams.on(stream):
                streams.wait(fence)  # every update of a batch before the window
                if store is None:
                    idx = prep["batch"].value["sparse"].reshape(-1, F, m)
                    pooled = emb.lookup(state, spec, idx)
                else:
                    pooled = state.lookup(prep["gids"], staged=True)
                return streams.publish(pooled)

        def make_ctx():
            return (store if store is not None else st.emb_state), streams.record(dev)

        pipe = StepPipeline(self.pipeline, 1, prepare=prepare, stage_fn=stage_fn,
                            make_ctx=make_ctx, end=end, name="sim-pipe")
        return pipe, stream

    def run(self, n_iters: int, *, log_every: int = 0,
            on_iter: Optional[Callable[[int, float], None]] = None,
            state: Optional[SimState] = None) -> Dict[str, Any]:
        """Train ``n_iters`` iterations. ``state`` resumes a prior run: the
        iteration numbering (the batch stream, the shadow clocks, the
        membership and mode schedules) continues from ``state.step``."""
        st = self.init_state() if state is None else state
        sc = self.sync_cfg
        elastic = self._elastic
        store: Optional[CachedStore] = None
        la = 0
        # batch ids on the host, shared by the prefetch horizon, the stager
        # and the cached step
        gid_memo: Dict[int, np.ndarray] = {}  # guarded-by: gid_lock
        gid_lock = threading.Lock()
        if self.cache is not None:
            store = CachedStore(st.emb_state, self.cache)
            st.emb_state = None
            # the prefetch horizon covers at least the staged lookups
            la = self.cache.effective_lookahead(self.pipeline.depth if self.pipeline else 1)
        offs = self.spec.offsets[None, :, None]

        def _gids(it: int) -> np.ndarray:
            # the peek: batch ``it``'s packed global ids, drawn again on the
            # host (the stream is a pure function of the iteration), once
            with gid_lock:
                g = gid_memo.get(it)
            if g is None:
                F, m = self.cfg.n_sparse_features, self.cfg.multi_hot
                ids = ctr.sparse_ids(self.cfg, self.seed, it, self.B * self.R * self.M)
                with gid_lock:
                    g = gid_memo.setdefault(it, ids.reshape(-1, F, m) + offs)
            return g

        losses: List[float] = []
        replica_losses: List[np.ndarray] = []
        sync_count = 0
        examples = 0
        start = int(st.step)
        # one lookup unit (the packed table or its store): n_shards=1
        pipe, stager = (self._stager(st, store, start + n_iters, _gids)
                        if self.pipeline is not None else (None, None))
        # (land_t, snapshot, fired_mask, launch_active)
        pending: Optional[Tuple[int, Any, np.ndarray, Optional[np.ndarray]]] = None
        # Mode switching: ``cur_mode`` is the cohort's mode; ``fr_anchor``
        # aligns the barrier cadence to the catch-up sync that opened a
        # fixed_rate phase, ``shadow_base`` seeds the staggered shadow clocks
        # from the last global sync (``last_global_sync``). All stay 0
        # without a switch, so a schedule-free run is the single-mode path.
        msched = self.mode_schedule
        cur_mode = sc.mode
        if msched is not None and start > 0:
            cur_mode = msched.mode_at(start - 1)  # the mode already in effect
        mode_events: List[Tuple[int, str, str]] = []
        last_global_sync = fr_anchor = shadow_base = 0
        try:
            for t in range(start, start + n_iters):
                if elastic and self.schedule is not None:
                    # a StragglerSchedule yields (kind, slot, reason)
                    evs = list(self.schedule.events_at(t))
                    if evs and pipe is not None:
                        pipe.drain()  # staged lookups predate the event
                    for ev in evs:
                        st = self._apply_membership_event(st, *ev)
                active = self.membership.active_mask() if elastic else None
                if msched is not None:
                    mode = msched.mode_at(t)
                    if mode != cur_mode:
                        # the handoff, at the iteration boundary: staged
                        # lookups predate it
                        if pipe is not None:
                            pipe.drain()
                        if mode == "fixed_rate":
                            # shadow -> fixed_rate: drop the in-flight launch
                            # and run one foreground catch-up sync, so stale
                            # deltas merge before the first barrier step
                            pending = None
                            if active is None or active.any():
                                st = self._apply_sync(st, None, None, active=active)
                                sync_count += self.R if active is None else int(active.sum())
                            last_global_sync = fr_anchor = t
                        else:
                            # fixed_rate -> shadow: the shadow clocks resume
                            # from the last global sync
                            shadow_base = last_global_sync
                        mode_events.append((t, cur_mode, mode))
                        cur_mode = mode
                staged = prep = None
                if pipe is not None:
                    staged, prep = pipe.consume(t)
                batch = streams.consume(prep["batch"]) if prep is not None else self.make_batch(t)
                pooled = (streams.consume(staged[0])
                          if staged is not None and staged[0] is not None else None)
                gids = None
                if store is not None:
                    # one prefetch round covering [t, t + K) at the boundary
                    if la:
                        store.prefetch([_gids(t + j) for j in range(la)])
                    gids = _gids(t)
                    with gid_lock:
                        for k in [k for k in gid_memo if k <= t]:
                            del gid_memo[k]
                loss = self._train_iter(
                    st, batch, active, store, gids, pooled,
                    on_dense=(lambda: pipe.stage(t)) if pipe is not None else None)
                # float()/numpy() synchronise, as float() does in the reference
                if elastic:
                    lv = loss.detach().cpu().numpy()
                    replica_losses.append(lv)
                    # an all-dead cohort trains nothing: nan, not a mean of []
                    losses.append(float(lv[active].mean()) if active.any() else float("nan"))
                    examples += int(active.sum()) * self.M * self.B
                else:
                    losses.append(float(loss))
                    examples += self.R * self.M * self.B
                if cur_mode == "fixed_rate":
                    if (t + 1 - fr_anchor) % sc.gap == 0 and (active is None or active.any()):
                        st = self._apply_sync(st, None, None, active=active)
                        sync_count += self.R if active is None else int(active.sum())
                        last_global_sync = t + 1
                else:  # shadow: land first, then launch
                    if pending is not None and t + 1 >= pending[0]:
                        _, snap, mask, launch_active = pending
                        # the landing reads the CURRENT membership: a slot that
                        # died in flight is skipped (an all-dead cohort drops it)
                        if active is None or active.any():
                            st = self._apply_sync(st, snap, mask, active=active,
                                                  launch_active=launch_active)
                            sync_count += int(mask.sum())
                        pending = None
                    if pending is None:
                        mask = self._shadow_schedule(t + 1 - shadow_base)
                        if elastic:
                            mask = mask & active  # a dead slot's clock never fires
                        if mask.any():
                            if sc.delay == 0:
                                # lands this iteration; no training step
                                # intervenes, so the pytree engine needs no
                                # deep copy
                                snap = (self._launch_snapshot(st, mask, active)
                                        if self.engine == "flat" else st.w_stack)
                                st = self._apply_sync(st, snap, mask, active=active,
                                                      launch_active=active)
                                sync_count += int(mask.sum())
                            else:
                                pending = (t + 1 + sc.delay,
                                           self._launch_snapshot(st, mask, active), mask, active)
                st.step = t + 1
                if on_iter:
                    on_iter(t, losses[-1])
                if log_every and (t + 1) % log_every == 0:
                    print(f"iter {t+1}: loss {np.mean(losses[-log_every:]):.5f}")
        finally:
            if pipe is not None:
                # quiesce the stager before the merge below (a staged lookup
                # still running would race the hot tier's drain)
                pipe.close()
                if stager is not None:
                    stager.synchronize()
        if store is not None:
            st.emb_state = store.merged()  # the canonical tables, as uncached
        # replica-iterations actually trained (dead slots do not count)
        replica_iters = examples // (self.M * self.B)
        out = {
            "state": st,
            "train_loss": losses,
            "sync_count": sync_count,
            "avg_sync_gap": replica_iters / max(sync_count, 1),
            "examples": examples,
        }
        if store is not None:
            out["cache_stats"] = store.stats.as_dict()
        if pipe is not None:
            out["pipeline_stats"] = pipe.stats.as_dict()
        if elastic:
            out["replica_losses"] = np.stack(replica_losses)
            out["membership_events"] = list(self.membership.events)
        if msched is not None:
            # (iteration, from_mode, to_mode) of each handoff this run applied
            out["mode_events"] = mode_events
            out["mode"] = cur_mode
        return out

    def replica_params(self, st: SimState, i: int) -> Tree:
        """Replica i's dense weights as a tree, whatever the engine."""
        if self.engine == "flat":
            return self.flat.unpack_replica(st.w_stack, i)
        return S.tree_slice(st.w_stack, i)

    def dense_stack(self, st: SimState) -> Tree:
        """The dense replica stack as a tree with leading R, whatever the
        engine: the on-disk form."""
        return self.flat.unpack_stack(st.w_stack) if self.engine == "flat" else st.w_stack

    # -- checkpoints -----------------------------------------------------------
    def _state_tree(self, st: SimState) -> Dict[str, Any]:
        """The on-disk tree, the JAX package's: dense replicas as the named
        stack, optimizer, embedding and algorithm state."""
        return {"w": self.dense_stack(st), "opt": st.opt_stack, "emb": st.emb_state,
                "algo": st.algo_state}

    def save_state(self, path: str, st: SimState,
                   metadata: Optional[Dict[str, Any]] = None) -> None:
        meta = {"step": st.step, "algo": self.sync_cfg.algo, "engine": self.engine,
                "R": self.R, "active_mask": [bool(b) for b in self.membership.active_mask()]}
        meta.update(metadata or {})
        ckpt.save(path, self._state_tree(st), metadata=meta)

    def load_state(self, path: str) -> SimState:
        """Elastic restore: the checkpoint's replica count may differ from
        this sim's capacity. Shrinking truncates the replica axis; every slot
        live now that was not live at save (grown, or dead when saved) is
        bootstrapped through the algorithm's join hook (the live mean, or
        EASGD's PS plane) with a fresh optimizer state."""
        meta0 = ckpt.read_metadata(path)
        for field, want in (("engine", self.engine), ("algo", self.sync_cfg.algo)):
            if field in meta0 and meta0[field] != want:
                raise ValueError(
                    f"checkpoint at {path!r} was saved with {field}={meta0[field]!r} but this "
                    f"sim runs {field}={want!r}; construct the sim to match (the algo_state "
                    f"layout is {field}-specific)")
        w0 = dlrm.init_dense(self.cfg, torch.Generator().manual_seed(self.seed),
                             device=self.device)
        # the tables' template has their shape, not their memory
        rows, d = self.spec.total_rows, self.spec.dim
        like_emb = {k: torch.empty((1, d), device=self.device).expand(rows, d)
                    for k in ("acc", "table")}
        like = self._state_tree(self._state_from(w0, like_emb))

        # only the replica-stacked trees may resize; a mismatch anywhere else
        # (embedding rows of another config) raises
        def replica_stacked(k: str) -> bool:
            return k.split("/")[0] in ("w", "opt")

        tree, meta, _ = ckpt.restore_elastic(path, like, may_resize=replica_stacked)
        w_stack = self.flat.pack_stack(tree["w"]) if self.engine == "flat" else tree["w"]
        st = SimState(w_stack, tree["opt"], tree["emb"], tree["algo"], int(meta.get("step", 0)))
        # donors: the restored cohort, the slots live at save (and kept)
        saved_R = int(meta.get("R", self.R))
        donors = np.zeros((self.R,), bool)
        k = min(saved_R, self.R)
        saved_active = meta.get("active_mask")
        donors[:k] = True if saved_active is None else np.asarray(saved_active, bool)[:k]
        sc, fs = self.sync_cfg, self.flat
        for slot in np.flatnonzero(self.membership.active_mask() & ~donors):
            slot = int(slot)
            if donors.any():
                if self.engine == "flat":
                    st.w_stack, st.algo_state = self.algo.on_join_flat(
                        st.w_stack, slot, st.algo_state, donors, sc, fs)
                else:
                    st.w_stack, st.algo_state = self.algo.on_join(
                        st.w_stack, slot, st.algo_state, donors, sc)
            st.opt_stack = S.tree_set(st.opt_stack, slot,
                                      self.opt.init(self.replica_params(st, slot)))
        return st

    @torch.no_grad()
    def evaluate(self, st: SimState, n_batches: int = 20, batch_size: int = 4096,
                 replica: int = 0) -> float:
        """Paper protocol: evaluate the FIRST trainer's replica."""
        w = self.replica_params(st, replica)
        tot = 0.0
        for i in range(n_batches):
            b = ctr.gen_batch(self.cfg, self.teacher, self.seed + 10_000_000, i, batch_size)
            pooled = emb.lookup(st.emb_state, self.spec, b["sparse"])
            tot += float(dlrm.bce_loss(dlrm.forward(w, b["dense"], pooled), b["labels"]))
        return tot / n_batches


# ---------------------------------------------------------------------------
# Real-thread runner (faithful Algorithm 1)
# ---------------------------------------------------------------------------

# the kernel sources the threaded path launches: K1, K2 and the four sync
# files (EASGD's pair K4; MA's mean and pull-back K5, which every non-EASGD
# join also runs; BMUF's K6; Gossip's pair K7)
THREADED_KERNELS = ("embedding_bag", "sparse_adagrad", "easgd_update", "ma_update",
                    "bmuf_update", "gossip_update")


class ThreadedShadowRunner:
    """Trainer threads + a background shadow thread over genuinely shared state.

    The embedding state is read and written WITHOUT a lock (Hogwild:
    concurrent trainers can lose updates; that is the point). Dense replicas
    are owned by their trainer; the shadow thread interpolates them in the
    background. The embedding collection is plan-sharded
    (``embeddings/shards.py``): lookups route by the LPT plan, one
    embedding-bag launch per shard, and each trainer's backward is one
    sparse-Adagrad launch per shard. The background round is built by the
    ``SyncAlgorithm`` (``make_shadow_round``) over the live planes, on the
    flat engine: for EASGD one out-of-place pair-kernel launch per live
    replica; for MA and BMUF one mean over the stacked planes, then one
    out-of-place pull-back per plane (BMUF's global step between, its
    ``(w_global, velocity)`` held only by the shadow thread); for Gossip one
    out-of-place pair exchange per ring pair. A join bootstraps through the
    algorithm's ``on_join`` hook (EASGD: the PS plane; the others: the live
    mean, K5 ``replica_mean_rows``).

    One GPU, several threads. The reference overlaps its threads because
    jitted compute releases the GIL and its arrays are immutable, swapped
    wholesale. Here:

    * every trainer thread, the shadow thread and the supervisor's tick run
      their device work on their own CUDA stream (``torch.cuda.stream``; the
      kernel wrappers launch on the current stream). Nothing of the hot path
      runs on the default stream and no thread calls
      ``torch.cuda.synchronize()``: ``float(loss)`` waits for the trainer's
      own stream only. ``run()`` completes all initial state on the device
      before it starts the threads;
    * where the reference swap-publishes (trainer i publishes ``w[i]``, the
      round republishes the cohort's planes and the algorithm state, a join
      bootstraps a plane), the port publishes a ``streams.Published``: the
      value plus a CUDA event recorded on the producer's stream after its
      last write. The reader ``streams.consume``s it: its stream waits on
      the event before the first read, and ``record_stream`` keeps the
      allocator from reusing the memory while the reader's stream may still
      read it. This holds both ways: trainer -> shadow (a round reads the
      planes) and shadow -> trainer (landed planes);
    * the embedding shards are updated in place, so trainers race row by
      row, and PS snapshots are copies (see ``embeddings/shards.py``). The
      shard tensors are ``record_stream``-ed for every thread's stream once,
      at the start of ``run()``.

    The tiered cache (``cache=``): each PS fronts its table with a
    ``CachedStore`` (``EmbeddingShards(cache=)``); trainers look up and
    update through the hot tiers, and the shadow thread (in fixed_rate the
    supervisor's tick) runs the lookahead prefetch between rounds, peeking
    each live trainer's next batches. ``cache_stats`` sums the stores'
    counters.

    Step pipelining (``pipeline=``): each trainer owns a ``StepPipeline``
    whose stager thread runs on a CUDA stream of its own, built before the
    run starts so ``share_with`` records the shard tensors on it. A staged
    per-shard lookup waits on an event the trainer recorded on its stream
    at ``stage`` time (after its dense dispatch, before its sparse updates)
    and returns its plane, and the batch it generated, as
    ``streams.Published``; the trainer consumes them, then looks up
    serially the shards that were not staged.

    The straggler policy (``straggler_policy=``) demotes and re-admits
    slots from their busy-clock pace each shadow round (in fixed_rate from
    a monitor thread, on a stream of its own), and the supervisor's tick
    backs it up. A demotion's leave hook runs where it is decided (its
    algorithm state goes out as ``streams.Published``); a re-admission is
    carried out by the slot's own trainer at the top of its next
    iteration, on its stream, where its new plane and optimizer state are
    read. The mode controller (``mode_controller=``) moves the whole
    cohort between shadow and fixed_rate from the pace dispersion: a run
    with one keeps both the barrier and the shadow thread, and a switch to
    fixed_rate runs one foreground catch-up round first."""

    def __init__(
        self,
        cfg,  # DLRMConfig
        sync_cfg: S.SyncConfig,
        *,
        n_trainers: int,
        batch_size: int,
        optimizer: Optimizer,
        emb_lr: float = 0.05,
        seed: int = 0,
        sync_sleep_s: float = 0.0,
        n_emb_shards: Optional[int] = None,
        fault_spec: Optional[FaultSpec] = None,
        membership: Optional[Membership] = None,
        eps_window_s: float = 2.0,
        straggler_policy: Optional[StragglerPolicy] = None,
        supervise: bool = True,
        supervisor_config: Optional[SupervisorConfig] = None,
        ps_snapshot_every: int = 2,
        shard_retry: Optional[emb_shards.ShardRetryPolicy] = None,
        cache=None,
        pipeline: Optional[PipelineConfig] = None,
        mode_controller: Optional[ModeController] = None,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.cache: Optional[CacheConfig] = cache.validate() if cache is not None else None
        self.cfg, self.sync_cfg = cfg, sync_cfg.validate()
        # the mode controller may move the cohort between shadow and
        # fixed_rate mid-run; the run starts in sync_cfg.mode
        self.mode_ctl = mode_controller
        if mode_controller is not None and mode_controller.mode != sync_cfg.mode:
            raise ValueError(
                f"mode_controller starts in {mode_controller.mode!r} but sync_cfg.mode is "
                f"{sync_cfg.mode!r}; construct them to agree")
        self.pipeline = pipeline.validate() if pipeline is not None else None
        self.engine = sync_cfg.engine
        self.algo = algorithms.get(sync_cfg.algo)
        self.R, self.B = n_trainers, batch_size
        # hogwild-race: ok — pure functions: update() returns new state, mutates nothing
        self.opt = optimizer
        self.emb_lr = emb_lr
        self.seed = seed
        self.sync_sleep_s = sync_sleep_s
        # Fault-injection harness + elastic membership: slots with a join_at
        # schedule start dead and bootstrap mid-run.
        self.fault = (fault_spec or FaultSpec()).validate(n_trainers)
        # the closed-loop straggler controller: evaluated each shadow round,
        # or by a monitor thread in static fixed_rate (no shadow thread)
        if straggler_policy is not None and straggler_policy.n_slots != n_trainers:
            raise ValueError(f"straggler_policy watches {straggler_policy.n_slots} slots, "
                             f"runner has {n_trainers} trainers")
        self.policy = straggler_policy
        if membership is None:
            membership = Membership.from_mask(
                [i not in self.fault.join_at for i in range(n_trainers)])
        if membership.R_max != n_trainers:
            raise ValueError(f"membership capacity {membership.R_max} != n_trainers {n_trainers}")
        self.membership = membership
        self.eps_window_s = eps_window_s
        self.spec = emb.spec_from_config(cfg)
        self.teacher = ctr.make_teacher(cfg, seed=seed + 777, device=self.device)
        self.flat = _dense_flatspace(cfg) if self.engine == "flat" else None
        if n_emb_shards is None:
            n_emb_shards = min(4, cfg.n_sparse_features)
        # The LPT bin_pack plan assigns tables to embedding PSs (paper §3.1).
        self.plan = emb_shards.plan_shards(self.spec, n_emb_shards, batch_size)
        self.n_emb_shards = self.plan.n_shards
        # Failure-domain supervision: heartbeats over every long-lived
        # thread, bounded shadow restarts, PS fail/recover orchestration.
        # Chaos injection rides the supervisor's watch loop, so a FaultSpec
        # that kills the sync thread or a PS requires supervise=True.
        self.supervise = bool(supervise)
        self.supervisor_config = (supervisor_config or SupervisorConfig()).validate()
        if ps_snapshot_every < 1:
            raise ValueError(f"ps_snapshot_every must be >= 1, got {ps_snapshot_every}")
        self.ps_snapshot_every = int(ps_snapshot_every)
        self.shard_retry = shard_retry
        for s in self.fault.ps_fail_at:
            if not 0 <= s < self.n_emb_shards:
                raise ValueError(f"ps_fail_at names shard {s}, but the plan has "
                                 f"{self.n_emb_shards} embedding shards")
        sync_chaos = self.fault.sync_crash_at is not None or self.fault.sync_stall_at is not None
        if sync_chaos and self.sync_cfg.mode == "fixed_rate" and self.mode_ctl is None:
            raise ValueError("sync_crash_at / sync_stall_at target the shadow thread; static "
                             "mode='fixed_rate' has none (auto-mode runs, with a "
                             "mode_controller, always keep one)")
        if (sync_chaos or self.fault.ps_fail_at) and not self.supervise:
            raise ValueError("FaultSpec injects sync/PS chaos, but supervise=False: the "
                             "supervisor is both the injection clock and the recovery path")
        self.supervisor: Optional[Supervisor] = None
        # per-shard in-place sparse-Adagrad writes, routed by the plan; they
        # bind the plan, not ``self``, so the runner holds no reference cycle
        plan = self.plan
        self._emb_updates = [
            lambda st, idx, g, s=s: emb_shards.shard_update(plan, s, st, idx, g, emb_lr)
            for s in range(self.n_emb_shards)]
        # The background round: a host callable from the algorithm that
        # replaces the live per-trainer planes/trees (Algorithm 1).
        self._shadow_round = self.algo.make_shadow_round(self.sync_cfg, self.flat)

    # -- one trainer iteration -------------------------------------------------
    def _train_dense(self, w, opt_state, pooled: torch.Tensor, batch):
        """Downstream of the lookup, for one replica: ``w`` is its plane
        (flat) or tree (pytree). Returns new (w, opt_state), the loss and the
        pooled gradient."""
        tree = self.flat.unpack(w) if self.flat is not None else w
        loss, g_w, g_pooled = dlrm.dense_loss_and_grads(tree, batch["dense"], pooled,
                                                        batch["labels"])
        tree, opt_state = self.opt.update(tree, opt_state, g_w)
        return (self.flat.pack(tree) if self.flat is not None else tree), opt_state, loss, g_pooled

    def warmup(self, iters: int = 1) -> None:
        """Build every kernel of the path (one ``backend.build`` call, one
        ``nvcc`` per source, all at once) and run ``iters`` iterations and one
        background round on throwaway state, so the supervisor's heartbeat
        clock never sees a first iteration paying for the build, the kernel
        load or the cuBLAS handle. Touches no membership, meter or measured
        state."""
        if self.device.type == "cuda":
            backend.build(THREADED_KERNELS)
        w0 = dlrm.init_dense(self.cfg, torch.Generator().manual_seed(self.seed), device=self.device)
        w = self.flat.pack(w0) if self.flat is not None else w0
        opt_state = self.opt.init(w0)
        d = self.spec.dim
        embs = emb_shards.EmbeddingShards(self.plan, [
            {k: torch.zeros((rows, d), device=self.device) for k in ("table", "acc")}
            for rows in self.plan.shard_rows], cache=self.cache)
        for it in range(iters):
            batch = ctr.gen_batch(self.cfg, self.teacher, self.seed, it, self.B)
            if self.cache is not None:
                sparse_np = batch["sparse"].cpu().numpy()
                pooled = embs.cached_lookup(sparse_np)
            else:
                pooled = embs.lookup(batch["sparse"])
            w, opt_state, _, g_pooled = self._train_dense(w, opt_state, pooled, batch)
            for s in range(self.n_emb_shards):
                if self.cache is not None:
                    embs.cached_update(s, sparse_np, g_pooled, self.emb_lr)
                else:
                    embs.try_update(s, self._emb_updates[s], batch["sparse"], g_pooled)
        if self.engine == "flat":
            algo_state = self.algo.init_state_flat(w, self.sync_cfg, self.flat)
        else:
            algo_state = self.algo.init_state(w, self.sync_cfg)
        n_live = max(int(self.membership.active_ids().size), 1)
        self._shadow_round([w] * n_live, algo_state)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # holds-lock: _state_lock
    def _dispatch_on_leave(self, slot: int) -> None:
        """Engine-dispatched algorithm hook for a departing slot. Caller
        holds ``_state_lock``."""
        state = streams.consume(self.algo_state)
        if self.engine == "flat":
            new = self.algo.on_leave_flat(state, slot, self.sync_cfg, self.flat)
        else:
            new = self.algo.on_leave(state, slot, self.sync_cfg)
        if new is not state:
            self.algo_state = streams.publish(new)

    # holds-lock: _state_lock
    def _admit_slot(self, slot: int, reason: str = "") -> None:
        """join -> bootstrap -> activate. Caller holds ``_state_lock``."""
        self.membership.join(slot, reason=reason)
        self._bootstrap_join(slot)
        self.membership.activate(slot)

    # holds-lock: _state_lock; lock-blocking: ok — admission must be atomic
    # with the membership transition; joins are rare and bounded (one stack
    # + the join hook over the live cohort, on the joiner's stream)
    def _bootstrap_join(self, i: int) -> None:
        """Bootstrap a joining slot through the algorithm's join hook (the
        live mean; EASGD: the PS plane) with a fresh optimizer state. The flat
        hook ``join_plane_flat`` sees a stack of the donor planes alone; the
        pytree ``on_join`` a COMPACT stack of [donor planes..., joiner plane],
        joiner last. The donors are exactly the live cohort. Runs on the
        joiner's stream."""
        donor_ids = [int(j) for j in self.membership.active_ids()]
        if not donor_ids:  # no live donors: keep the slot's current weights
            self.opt_states[i] = self.opt.init(self._w0)
            return
        slot = len(donor_ids)  # joiner's position in the compact stack
        state = streams.consume(self.algo_state)
        if self.engine == "flat":
            donors = torch.stack([streams.consume(self.w[j]) for j in donor_ids])
            w_i, new_state = self.algo.join_plane_flat(donors, state, np.ones(slot, bool),
                                                       self.sync_cfg, self.flat)
        else:
            planes = [streams.consume(self.w[j]) for j in donor_ids + [i]]
            active = np.asarray([True] * slot + [False])
            stack, new_state = self.algo.on_join(algorithms._stack_trees(planes), slot, state,
                                                 active, self.sync_cfg)
            w_i = S.tree_slice(stack, slot)
        ev = streams.record(self.device)
        self.w[i] = streams.Published(w_i, ev)
        if new_state is not state:
            self.algo_state = streams.Published(new_state, ev)
        self.opt_states[i] = self.opt.init(self._w0)

    def _merged_pipe_stats(self) -> Dict[str, Any]:
        """The per-trainer pipeline counters (harvested in each trainer's
        ``finally``), summed after the join."""
        total = PipelineStats()
        for st in self._pipe_stats:
            if st is not None:
                total.add(st)
        return total.as_dict()

    def _trainer_pipeline(self, i: int, n_iters: int, stream,
                          peek: Callable[[int], np.ndarray]) -> StepPipeline:
        """Trainer ``i``'s step pipeline over the PS shards. The trainer's
        stream of batches is pure in (seed + i, iteration), so the stager
        makes batch ``it`` with ``gen_batch`` on its own CUDA ``stream``; its
        rows are the batch's own ids uncached, and cached the host ids
        ``peek(it)`` that the prefetch horizon reads (one draw). The hazard
        check is self read-after-write only (the other trainers' writes are
        the Hogwild race the serial path has too). A membership transition
        or a PS fail/recover between staging and use drains the value."""
        dev, plan, cached = self.device, self.plan, self.cache is not None

        def prepare(it: int) -> Dict[str, Any]:
            with streams.on(stream):
                b = ctr.gen_batch(self.cfg, self.teacher, self.seed + i, it, self.B)
                ready = streams.record(dev)
                sp = peek(it) if cached else b["sparse"].cpu().numpy()
            rows = [np.unique(emb_shards._route_np(plan, s, sp)) for s in range(plan.n_shards)]
            return {"rows": rows, "batch": streams.Published(b, ready), "sparse": sp}

        def stage_fn(s: int, it: int, prep: Dict[str, Any], ctx) -> streams.Published:
            embs, fence = ctx
            with streams.on(stream):
                streams.wait(fence)  # this trainer's updates of every earlier batch
                ids = prep["sparse"] if cached else prep["batch"].value["sparse"]
                return streams.publish(embs.lookup_shard(s, ids, staged=True))

        return StepPipeline(self.pipeline, plan.n_shards, prepare=prepare, stage_fn=stage_fn,
                            make_ctx=lambda: (self.emb, streams.record(dev)),
                            epoch=lambda: self.membership.epoch,
                            shard_token=self.emb.incarnation, end=n_iters, name=f"pipe-{i}")

    def run(self, iters_per_trainer: int) -> Dict[str, Any]:
        dev = self.device
        gen = torch.Generator().manual_seed(self.seed)
        w0 = dlrm.init_dense(self.cfg, gen, device=dev)
        self._w0 = w0  # hogwild-race: ok — written once pre-spawn, read-only after
        # Per-PS Hogwild states, seed-identical to the packed single table.
        # hogwild-race: ok — bound once pre-spawn; rebinding after spawn is a bug
        self.emb = emb_shards.EmbeddingShards.init(self.plan, gen, retry=self.shard_retry,
                                                   cache=self.cache, device=dev)
        if self.engine == "flat":
            plane0 = self.flat.pack(w0)
            w_init = [plane0.clone() for _ in range(self.R)]
            algo_state = self.algo.init_state_flat(plane0, self.sync_cfg, self.flat)
        else:
            w_init = [T.map(torch.clone, w0) for _ in range(self.R)]
            algo_state = self.algo.init_state(w0, self.sync_cfg)
        # swap-published: elements — fresh optimizer state per publish
        self.opt_states = [self.opt.init(w0) for _ in range(self.R)]
        # all initial state complete on the device before any thread starts
        init_event = streams.record(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # swap-published: elements — trainer i publishes w[i]; the round
        # republishes the cohort's planes and the algorithm state
        self.w: List[streams.Published] = [streams.Published(x, init_event) for x in w_init]
        self.algo_state = streams.Published(algo_state, init_event)  # guarded-by: _state_lock
        trainer_streams = [streams.new_stream(dev) for _ in range(self.R)]
        shadow_stream, tick_stream = streams.new_stream(dev), streams.new_stream(dev)
        # the monitor (the policy in static fixed_rate) may demote a slot:
        # its leave hook runs on the monitor's stream
        monitor_stream = streams.new_stream(dev) if self.policy is not None else None
        # each trainer's stager looks the shards up on a stream of its own;
        # made here so the shards are recorded on it before any launch
        stager_streams = ([streams.new_stream(dev) for _ in range(self.R)]
                          if self.pipeline is not None else [])
        self.emb.share_with(trainer_streams + [shadow_stream, tick_stream, monitor_stream]
                            + stager_streams)
        self.done = threading.Event()
        self.examples = 0  # guarded-by-writes: ex_lock
        self.sync_count = 0  # guarded-by-writes: _sync_lock
        # Failure-domain bookkeeping: captured trainer exceptions (re-raised
        # with slot provenance after join), dead sync-thread incarnations,
        # restart/degradation state, PS chaos tracking.
        self._trainer_excs: List[Tuple[int, BaseException]] = []  # guarded-by-writes: _state_lock
        # hogwild-race: ok — append-only post-mortem log, atomic under the GIL
        self._sync_excs: List[BaseException] = []
        # hogwild-race: ok — single logical writer (generation-fenced shadow)
        self._shadow_rounds = 0
        self._sync_degraded = False  # hogwild-race: ok — single store, read post-join
        self._sync_stalled = False  # hogwild-race: ok — same contract
        self._sync_crash_t: Optional[float] = None  # hogwild-race: ok — same contract
        # hogwild-race: ok — restart hook appends; read post-join
        self._sync_count_at_restart: List[int] = []
        self._ps_injected: set = set()  # hogwild-race: ok — supervision tick owns it
        self._tick_count = 0  # hogwild-race: ok — supervision tick owns it
        self._sync_lock = threading.Lock()  # shadow/trainer threads both add
        # serializes algo_state transitions: the shadow round vs the rare
        # crash/join handlers
        self._state_lock = threading.Lock()
        # guarded-by-writes: ex_lock — adds share examples' lock; eps reads are lock-free
        self.eps_meter = EPSMeter(window_s=self.eps_window_s)
        # per-slot meters on each trainer's BUSY clock (barrier waits excluded)
        self.slot_eps = SlotEPS(self.R, window_s=self.eps_window_s)  # hogwild-race: ok — slot-owned
        self._alive = [True] * self.R  # guarded-by-writes: _state_lock
        # The policy's pending re-admissions, each taken by its slot's trainer.
        # guarded-by-writes: _state_lock — a trainer checks its own slot
        # lock-free once an iteration; _take_readmit re-reads and clears it
        # under the lock before acting, so a stale read costs one iteration
        self._readmit_reason: List[Optional[str]] = [None] * self.R
        self.iter_count = [0] * self.R  # hogwild-race: ok — slot-owned counters
        trainer_wall = [0.0] * self.R  # hogwild-race: ok — slot-owned cells, read post-join
        # per-trainer step pipelines and their stats
        # hogwild-race: ok — slot-owned cells
        self._pipes: List[Optional[StepPipeline]] = [None] * self.R
        # hogwild-race: ok — slot-owned cells, merged post-join
        self._pipe_stats: List[Optional[PipelineStats]] = [None] * self.R
        # hogwild-race: ok — slot-owned lists, merged post-join
        losses: List[List[float]] = [[] for _ in range(self.R)]
        # quality signals: each slot's loss EMA (the policy's loss
        # divergence, the controller's quality skew) and the perf_counter
        # stamp of its last landed sync (the policy's staleness)
        # hogwild-race: ok — slot-owned cells (each trainer writes only its
        # own; reader threads see a coherent latest float)
        self._loss_ema = [float("nan")] * self.R
        # guarded-by-writes: _state_lock — written by the round's publish;
        # lock-free reads see a coherent latest stamp
        self._last_sync_t = [time.perf_counter()] * self.R
        ex_lock = threading.Lock()
        auto = self.mode_ctl is not None
        # static fixed_rate has no shadow thread (a monitor carries the
        # policy); an auto-mode run always keeps it, as the mode and policy
        # evaluator even while the barrier owns the rounds
        fr_static = (not auto) and self.sync_cfg.mode == "fixed_rate"
        has_fr = fr_static or auto
        # The cohort's current mode, moved by _apply_mode_switch.
        # guarded-by-writes: _fr_cond — trainers read it lock-free each
        # iteration; a stale read is bounded-safe (an unregistered waiter
        # returns at once from the sync point, and a trainer that misses one
        # barrier boundary re-arrives at its next gap)
        self._mode = self.sync_cfg.mode
        # bumped on every handoff: trainers drain their pipelines on seeing it
        self._mode_gen = 0  # guarded-by-writes: _fr_cond
        if has_fr:
            # Foreground sync point: a Condition-based barrier whose party
            # count tracks membership, so a crash shrinks it instead of
            # deadlocking; a straggler still drags EVERYONE (the paper's
            # fixed-rate failure mode).
            self._fr_cond = threading.Condition()
            # guarded-by: _fr_cond
            self._fr_registered = [bool(b) for b in self.membership.active_mask()]
            # per-slot arrival flags: the barrier fires only when every
            # REGISTERED slot has arrived
            self._fr_arrived = [False] * self.R  # guarded-by: _fr_cond
            self._fr_gen = 0  # guarded-by: _fr_cond
            # slot id of the thread elected to run the current round
            self._fr_leader: Optional[int] = None  # guarded-by: _fr_cond
        initial_active = set(int(j) for j in self.membership.active_ids())
        self._initial_running = len(initial_active)  # guarded-by-writes: ex_lock

        def _progress() -> int:
            return max((self.iter_count[j] for j in initial_active), default=iters_per_trainer)

        def _add_syncs(n: int) -> None:
            with self._sync_lock:
                self.sync_count += n

        def _beat(name: str) -> None:
            # `sup` is bound later in run(); closures resolve it at call time
            if sup is not None:
                sup.beat(name)

        # Lookahead prefetch: each trainer's stream is a pure function of
        # (seed + slot, iteration), so the next K batches of every live
        # trainer are peeked (drawn again on the host, memoized across
        # rounds) and their per-shard rows promoted between rounds. A trainer
        # that outruns the horizon pays a counted synchronous promotion.
        peek_memo: Dict[Tuple[int, int], np.ndarray] = {}  # guarded-by: peek_lock
        peek_lock = threading.Lock()
        # one prefetch round at a time: a shadow incarnation that finds the
        # flag up (a restart race) skips its round; the migrations run with
        # no lock held (they wait on the card)
        prefetch_busy = [False]  # guarded-by: prefetch_lock
        prefetch_lock = threading.Lock()

        def _peek(i: int, it: int) -> np.ndarray:
            # trainer i's batch ``it`` ids on the host, drawn once for the
            # prefetch horizon and the stager; entries it trained past go
            with peek_lock:
                idx = peek_memo.get((i, it))
            if idx is None:
                idx = ctr.sparse_ids(self.cfg, self.seed + i, it, self.B)
                with peek_lock:
                    idx = peek_memo.setdefault((i, it), idx)
                    for k in [k for k in peek_memo if k[1] < self.iter_count[k[0]]]:
                        del peek_memo[k]
            return idx

        def _prefetch_step() -> None:
            if self.cache is None or self.cache.lookahead == 0:
                return
            la = self.cache.effective_lookahead()
            with prefetch_lock:
                if prefetch_busy[0]:
                    return  # another incarnation (a restart race) is mid-round
                prefetch_busy[0] = True
            try:
                horizons: List[List[np.ndarray]] = [[] for _ in range(self.n_emb_shards)]
                for i in range(self.R):
                    if not self._alive[i]:
                        continue
                    base = self.iter_count[i]
                    for it in range(base, min(base + la, iters_per_trainer)):
                        idx = _peek(i, it)
                        for s in range(self.n_emb_shards):
                            horizons[s].append(emb_shards._route_np(self.plan, s, idx))
                for s in range(self.n_emb_shards):
                    store = self.emb.stores[s]
                    if store is not None and self.emb.health[s]:
                        store.prefetch(horizons[s])
            finally:
                with prefetch_lock:
                    prefetch_busy[0] = False

        def _round_over_active() -> int:
            # The round runs over the LIVE planes only. It is kernel dispatch,
            # so it runs outside _state_lock: capture the cohort and the
            # algorithm state under the lock, run the round on this thread's
            # stream, then publish only if neither moved meanwhile. A
            # discarded round is harmless: the next one syncs fresher planes.
            with self._state_lock:
                epoch = self.membership.epoch
                ids = self.membership.active_ids()
                if ids.size == 0:
                    return 0
                state_in = self.algo_state
                sub_in = [self.w[j] for j in ids]
            sub = [streams.consume(p) for p in sub_in]
            new_state, n = self._shadow_round(sub, streams.consume(state_in))
            landed = streams.record(dev)  # after the round's last write
            with self._state_lock:
                if self.membership.epoch != epoch or self.algo_state is not state_in:
                    return 0  # membership/algo state moved under the round
                self.algo_state = streams.Published(new_state, landed)
                now_sync = time.perf_counter()
                for k, j in enumerate(ids):
                    self.w[j] = streams.Published(sub[k], landed)
                    self._last_sync_t[j] = now_sync  # the slot's staleness resets
                return n

        def _fr_ready_locked() -> bool:  # holds-lock: _fr_cond
            regs = [j for j in range(self.R) if self._fr_registered[j]]
            return bool(regs) and all(self._fr_arrived[j] for j in regs)

        def _fr_deregister(i: int) -> None:
            with self._fr_cond:
                self._fr_registered[i] = False
                self._fr_cond.notify_all()

        def _fr_register(i: int) -> None:
            # only a live thread may rejoin the barrier
            with self._fr_cond:
                if self._alive[i] and not self._fr_registered[i]:
                    self._fr_registered[i] = True
                    self._fr_arrived[i] = False
                self._fr_cond.notify_all()

        def _fr_sync_point(i: int) -> None:
            run_round = False
            with self._fr_cond:
                if not self._fr_registered[i]:
                    return
                gen_ = self._fr_gen
                self._fr_arrived[i] = True
                # wait until every REGISTERED slot arrived and no elected
                # leader is still mid-round for this generation
                while (self._fr_gen == gen_ and self._fr_registered[i]
                       and not (_fr_ready_locked() and self._fr_leader is None)):
                    self._fr_cond.wait(timeout=0.05)
                    _beat(f"trainer-{i}")  # parked at the barrier is not a stall
                    if self._fr_gen == gen_ and self._fr_registered[i]:
                        self._fr_arrived[i] = True
                if self._fr_gen == gen_ and not self._fr_registered[i]:
                    self._fr_arrived[i] = False
                    self._fr_cond.notify_all()
                    return
                if self._fr_gen == gen_:
                    # every registered slot is here: this thread is elected
                    # leader and runs the round for the whole cohort, on its
                    # own stream, outside the condition
                    self._fr_leader = i
                    run_round = True
            if not run_round:
                return
            n = 0
            try:
                n = _round_over_active()
            finally:
                # the generation MUST advance even if the round raised
                with self._fr_cond:
                    for j in range(self.R):
                        self._fr_arrived[j] = False
                    self._fr_leader = None
                    self._fr_gen += 1
                    self._fr_cond.notify_all()
            if n:
                _add_syncs(n)

        def _demote(slot: int, reason: str) -> None:
            """Policy demotion: active -> dead ("leave", with provenance). The
            trainer keeps running (its iterations are the probe stream the
            policy watches for re-admission), but its replica leaves the sync
            set, its embedding writes stop and it leaves the barrier."""
            with self._state_lock:
                if not self.membership.active_mask()[slot]:
                    return  # crashed or left between observation and action
                self.membership.leave(slot, reason=reason)
                self._dispatch_on_leave(slot)
            if has_fr:
                _fr_deregister(slot)

        def _readmit(slot: int, reason: str) -> None:
            """Policy re-admission after probation: the decision is handed to
            the slot's own trainer, which carries it out at the top of its
            next iteration (``_take_readmit``), on its own stream, so the
            bootstrap's weights and fresh optimizer state are made where the
            trainer reads them."""
            with self._state_lock:
                # alive is cleared under this lock when a trainer exits, so a
                # finished trainer is never resurrected here
                if self._alive[slot] and self.membership.status(slot) == "dead":
                    self._readmit_reason[slot] = reason

        def _take_readmit(i: int) -> None:
            """dead -> joining -> active for slot ``i``, on its trainer's
            thread and stream: bootstrapped from the live cohort like a fresh
            join."""
            with self._state_lock:
                reason, self._readmit_reason[i] = self._readmit_reason[i], None
                if reason is None or self.membership.status(i) != "dead":
                    return
                self._admit_slot(i, reason=reason)
            if has_fr:
                _fr_register(i)

        def _policy_step() -> None:
            policy = self.policy
            if policy is None:
                return
            now = time.perf_counter()
            pcfg = policy.config
            # the quality observations only when their knob is set
            loss_by = ({i: self._loss_ema[i] for i in range(self.R)}
                       if pcfg.loss_div_frac is not None else None)
            stale_by = ({i: now - self._last_sync_t[i] for i in range(self.R)}
                        if pcfg.staleness_max is not None else None)
            actions = policy.observe(now, self.slot_eps.eps_by_slot(),
                                     self.membership.active_mask(), list(self._alive),
                                     loss_by_slot=loss_by, staleness_by_slot=stale_by)
            for a in actions:
                if a.kind == "demote":
                    _demote(a.slot, a.reason)
                else:
                    _readmit(a.slot, a.reason)

        def _quality_skew() -> float:
            # the live cohort's loss-EMA divergence: max slot EMA over the median
            active = self.membership.active_mask()
            vals = [self._loss_ema[i] for i in range(self.R) if active[i] and self._alive[i]]
            vals = [v for v in vals if v == v and v > 0.0]
            if len(vals) < 2:
                return 0.0
            med = median_eps(vals)
            return max(vals) / med if med > 0.0 else 0.0

        def _apply_mode_switch(dec: ModeDecision, gen_: Optional[int]) -> None:
            # One whole-cohort handoff, fenced by the supervisor's generation
            # token: a replaced shadow incarnation must not run one beside
            # its replacement (the supervisor's own tick passes None)
            if gen_ is not None and sup is not None and sup.generation("shadow") != gen_:
                return
            if dec.target == "fixed_rate":
                # shadow -> fixed_rate: one foreground catch-up round BEFORE
                # the barrier arms, so the first synchronous step starts from
                # consensus
                n = _round_over_active()
                if n:
                    _add_syncs(n)
            with self._fr_cond:
                if self._mode == dec.target:
                    return  # another switcher already made this handoff
                active = self.membership.active_mask()
                arm = dec.target == "fixed_rate"
                for j in range(self.R):
                    self._fr_arrived[j] = False
                    self._fr_registered[j] = bool(arm and self._alive[j] and active[j])
                # fixed_rate -> shadow: the generation bump drains the
                # barrier (every parked waiter trains on without a round)
                self._fr_leader = None
                self._fr_gen += 1
                self._mode = dec.target
                self._mode_gen += 1  # trainers drain their staged lookups
                self._fr_cond.notify_all()
            self.membership.note("mode_switch", -1, f"-> {dec.target}: {dec.reason}")

        def _mode_step(gen_: Optional[int]) -> None:
            ctl = self.mode_ctl
            if ctl is None:
                return
            disp = ModeController.dispersion(self.slot_eps.eps_by_slot(),
                                             self.membership.active_mask(), list(self._alive))
            dec = ctl.observe(time.perf_counter(), disp, quality_skew=_quality_skew())
            if dec is not None:
                _apply_mode_switch(dec, gen_)

        def trainer(i: int):
            try:
                with streams.on(trainer_streams[i]):
                    _trainer_body(i)
            except BaseException as e:
                # a dying trainer must not die silently: capture with slot
                # provenance (re-raised after join) and record the failure
                with self._state_lock:
                    self._trainer_excs.append((i, e))
                    if self.membership.status(i) != "dead":
                        self.membership.fail(i, reason=f"exception: {type(e).__name__}: {e}")
                        with streams.on(trainer_streams[i]):
                            self._dispatch_on_leave(i)
            finally:
                # stop the slot's stager (crash and raise exits included) and
                # harvest its stats before the thread ends
                pipe = self._pipes[i]
                if pipe is not None:
                    pipe.close()
                    self._pipe_stats[i] = pipe.stats
                    if stager_streams[i] is not None:
                        stager_streams[i].synchronize()
                with self._state_lock:
                    self._alive[i] = False
                if has_fr:
                    _fr_deregister(i)
                if sup is not None:
                    sup.deregister(f"trainer-{i}")
                if i in initial_active:
                    with ex_lock:
                        self._initial_running -= 1

        def _trainer_body(i: int):
            n_iters = iters_per_trainer
            # the initial optimizer state was made on the main thread's stream
            streams.consume(streams.Published(self.opt_states[i], init_event))
            if i in self.fault.join_at:
                target = self.fault.join_at[i]
                while _progress() < target:
                    if _progress() >= iters_per_trainer or self._initial_running == 0:
                        return  # cohort finished (or all crashed) before the join point
                    _beat(f"trainer-{i}")  # waiting to join is not a stall
                    time.sleep(0.001)
                with self._state_lock:
                    self._admit_slot(i)
                if has_fr:
                    _fr_register(i)
                n_iters = max(iters_per_trainer - target, 1)
            pipe = self._pipes[i] = (
                self._trainer_pipeline(i, n_iters, stager_streams[i], lambda it: _peek(i, it))
                if self.pipeline is not None else None)
            t_start = time.perf_counter()
            sleep_s = self.fault.straggler_sleep_s.get(i, 0.0)
            sleep_until = self.fault.straggler_until.get(i)
            crash = self.fault.crash_at.get(i)
            boom = self.fault.raise_at.get(i)
            seen_mode_gen = self._mode_gen
            for it in range(n_iters):
                _beat(f"trainer-{i}")
                if self._readmit_reason[i] is not None:
                    _take_readmit(i)  # the policy re-admitted this slot
                if pipe is not None and self._mode_gen != seen_mode_gen:
                    # a mode handoff since the last check: the staged
                    # lookups predate it (drained on this, the owning, thread)
                    seen_mode_gen = self._mode_gen
                    pipe.drain()
                if boom is not None and it >= boom:
                    raise RuntimeError(f"injected trainer fault at iteration {it}")
                if crash is not None and it >= crash:
                    with self._state_lock:
                        if self.membership.status(i) != "dead":
                            self.membership.fail(i)
                            self._dispatch_on_leave(i)
                    if has_fr:
                        _fr_deregister(i)
                    break
                t_busy = time.perf_counter()
                if sleep_s and (sleep_until is None or it < sleep_until):
                    time.sleep(sleep_s)  # injected degradation
                staged = prep = None
                if pipe is not None:
                    staged, prep = pipe.consume(it)
                if prep is not None:
                    batch, sparse_np = streams.consume(prep["batch"]), prep["sparse"]
                else:
                    batch = ctr.gen_batch(self.cfg, self.teacher, self.seed + i, it, self.B)
                    sparse_np = batch["sparse"].cpu().numpy() if self.cache is not None else None
                if pipe is not None:
                    # the staged planes where the hazard check allowed it;
                    # the other shards looked up here, bitwise the same
                    ids = sparse_np if self.cache is not None else batch["sparse"]
                    outs = []
                    for s in range(self.n_emb_shards):
                        if staged[s] is None:
                            outs.append(self.emb.lookup_shard(s, ids))
                        else:
                            outs.append(streams.consume(staged[s]))
                            self.emb.count_staged(s, ids)
                    pooled = self.emb.assemble(outs)
                elif self.cache is not None:
                    # through the per-PS hot tiers (a row that beat the
                    # prefetch horizon is promoted synchronously, counted)
                    pooled = self.emb.cached_lookup(sparse_np)
                else:
                    # Lock-free read of the shared per-PS tables (Hogwild).
                    pooled = self.emb.lookup(batch["sparse"])
                w, opt_state, loss, g_pooled = self._train_dense(
                    streams.consume(self.w[i]), self.opt_states[i], pooled, batch)
                if pipe is not None:
                    # stage batch it+1.. while this step's dense pass and
                    # sparse updates run
                    pipe.stage(it)
                self.w[i] = streams.publish(w)
                self.opt_states[i] = opt_state
                # Lock-free in-place write PER SHARD: writers to different
                # PSs proceed independently; writers to the same PS race row
                # by row (the Hogwild property). A dead slot keeps its
                # private state but does not write the shared tables.
                is_member = self.membership.status(i) == "active"
                if is_member:
                    for s in range(self.n_emb_shards):
                        if self.cache is not None:
                            self.emb.cached_update(s, sparse_np, g_pooled, self.emb_lr)
                        else:
                            self.emb.try_update(s, self._emb_updates[s], batch["sparse"],
                                                g_pooled)
                lv = float(loss)  # waits for this trainer's stream only
                losses[i].append(lv)
                prev = self._loss_ema[i]  # slot-owned: the quality signal
                self._loss_ema[i] = lv if prev != prev else 0.9 * prev + 0.1 * lv
                self.iter_count[i] = it + 1
                self.slot_eps.tick(i, time.perf_counter() - t_busy)
                self.slot_eps.add(i, self.B)
                if is_member:
                    with ex_lock:
                        self.examples += self.B
                        self.eps_meter.add(self.B)
                if has_fr and (it + 1) % self.sync_cfg.gap == 0 and self._mode == "fixed_rate":
                    _fr_sync_point(i)
            trainer_wall[i] = time.perf_counter() - t_start

        def _shadow_body(gen_: int):
            # One incarnation of the shadow loop. A restarted incarnation
            # resumes rounds against the LIVE membership state; ``gen_`` is the
            # supervisor's generation token at spawn, so a stalled zombie
            # whose replacement already runs stands down.
            while not self.done.is_set():
                if sup is not None and sup.generation("shadow") != gen_:
                    return  # fenced out: a replacement owns the rounds now
                r = self._shadow_rounds
                if (self.fault.sync_crash_at is not None and r >= self.fault.sync_crash_at
                        and self._sync_crash_t is None):
                    self._sync_crash_t = time.perf_counter()
                    raise RuntimeError(f"injected sync-thread crash at round {r}")
                if (self.fault.sync_stall_at is not None and r >= self.fault.sync_stall_at
                        and not self._sync_stalled):
                    # wedge WITHOUT beating: the supervisor must detect the
                    # stale heartbeat, fence this incarnation, and restart
                    self._sync_stalled = True
                    t_end = time.perf_counter() + self.fault.sync_stall_s
                    while time.perf_counter() < t_end and not self.done.is_set():
                        time.sleep(0.01)
                    continue  # the generation check above retires the zombie
                _beat("shadow")
                if auto and self._mode == "fixed_rate":
                    # the barrier's leaders own the rounds in fixed_rate; this
                    # thread idles as the mode and policy evaluator
                    time.sleep(0.001)
                else:
                    # One algorithm-owned background round over the live
                    # planes: landings interpolate into the CURRENT state
                    # while trainers keep moving (paper §3.3).
                    n = _round_over_active()
                    if n:
                        _add_syncs(n)
                    else:
                        time.sleep(0.001)
                self._shadow_rounds = r + 1
                # the cache's lookahead prefetch rides between the rounds, and
                # PS snapshots the shadow cadence (copies on this stream)
                _prefetch_step()
                if self._shadow_rounds % self.ps_snapshot_every == 0:
                    self.emb.snapshot_all()
                # membership and the cohort's mode are re-evaluated each round
                _policy_step()
                _mode_step(gen_)
                if self.sync_sleep_s:
                    time.sleep(self.sync_sleep_s)

        def shadow(gen_: int = 0):
            try:
                with streams.on(shadow_stream):
                    _shadow_body(gen_)
            except BaseException as e:
                # die quietly: the supervisor's death detection (and the
                # restart it triggers) IS the recovery path
                self._sync_excs.append(e)

        def _restart_shadow() -> threading.Thread:
            # called by the supervisor after backoff; the generation token
            # was already bumped, fencing any stalled zombie
            with self._sync_lock:
                self._sync_count_at_restart.append(self.sync_count)
            gen_ = sup.generation("shadow")
            self.membership.note(
                "sync_restart", -1,
                f"shadow thread restarted (attempt {len(self._sync_count_at_restart)}, "
                f"generation {gen_})")
            t = threading.Thread(target=shadow, args=(gen_,), daemon=True)
            t.start()
            return t

        def _sync_give_up(name: str) -> None:
            # degradation ladder, last rung: training keeps running locally,
            # and run() forces one final FOREGROUND sync at shutdown
            self._sync_degraded = True
            self.membership.note(
                "degraded", -1,
                "sync engine degraded: restart budget exhausted; training "
                "continues locally, final foreground sync at shutdown")

        def _supervision_tick() -> None:
            with streams.on(tick_stream):
                _tick_body()

        def _tick_body() -> None:
            # PS chaos injection + timed recovery ride the watch loop
            if fr_static:
                # no shadow thread: the prefetch and the PS snapshots take the
                # watch-loop cadence
                self._tick_count += 1
                _prefetch_step()
                if self._tick_count % 10 == 0:
                    self.emb.snapshot_all()
            for s, at in self.fault.ps_fail_at.items():
                if s not in self._ps_injected and _progress() >= at:
                    self._ps_injected.add(s)
                    self.emb.fail_shard(s, reason=f"injected PS failure at iteration {at}")
                    self.membership.note(
                        "ps_fail", -1,
                        f"embedding shard {s} down: live state lost, serving "
                        f"snapshot reads, dropping writes after retry")
            now = time.perf_counter()
            for s in list(self.emb.failed_at):
                t_fail = self.emb.failed_at.get(s)
                if t_fail is not None and now - t_fail >= self.fault.ps_recover_after_s:
                    self.emb.recover_shard(
                        s, reason=f"rehydrated from snapshot after {now - t_fail:.2f}s down")
                    self.membership.note("ps_recover", -1,
                                         f"embedding shard {s} rejoined the routing plan")
            # the backup policy and mode clock: decisions keep flowing while
            # the thread that normally makes them (the shadow) restarts
            _policy_step()
            _mode_step(None)

        def monitor():
            # static fixed_rate has no shadow thread: the policy gets its own
            # (a demotion must not wait for the barrier the straggler blocks)
            with streams.on(monitor_stream):
                while not self.done.is_set():
                    _beat("monitor")
                    _policy_step()
                    time.sleep(0.02)

        sup = Supervisor(self.supervisor_config, tick=_supervision_tick) if self.supervise else None
        self.supervisor = sup
        threads = [threading.Thread(target=trainer, args=(i,), name=f"trainer-{i}")
                   for i in range(self.R)]
        shadow_t = None if fr_static else threading.Thread(target=shadow, args=(0,), daemon=True)
        monitor_t = (threading.Thread(target=monitor, daemon=True)
                     if fr_static and self.policy is not None else None)
        # register BEFORE starting anything: a fast-finishing thread must
        # never race its own registration (it deregisters itself on exit)
        if sup is not None:
            for i, t in enumerate(threads):
                sup.register(f"trainer-{i}", t)  # watch-only
            if shadow_t is not None:
                sup.register("shadow", shadow_t, restart=_restart_shadow,
                             on_give_up=_sync_give_up)
            if monitor_t is not None:
                sup.register("monitor", monitor_t)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        if shadow_t is not None:
            shadow_t.start()
        if monitor_t is not None:
            monitor_t.start()
        if sup is not None:
            sup.start()
        for t in threads:
            t.join()
        self.done.set()
        sync_restarts = 0
        if sup is not None:
            sync_restarts = sup.restarts("shadow")
            cur = sup.thread("shadow")
            if cur is not None:
                shadow_t = cur  # join the CURRENT incarnation, not gen 0
            # clean shutdown: stop watching first, or the supervisor would
            # read the loops' clean exits as deaths
            sup.deregister("shadow")
            sup.deregister("monitor")
            sup.stop()
            # the tick closes over this run's state and the runner: drop it,
            # so a finished runner is freed when its last name goes (its
            # device memory with it), not only by the cyclic collector
            sup.tick = None
        if shadow_t is not None:
            shadow_t.join(timeout=5.0)
            if shadow_t.is_alive():
                warnings.warn(
                    "shadow thread failed to exit within 5s at shutdown "
                    "(sync engine wedged?); proceeding: the returned state "
                    "may race one final background round", RuntimeWarning)
        if monitor_t is not None:
            monitor_t.join(timeout=5.0)
            if monitor_t.is_alive():
                warnings.warn("monitor thread failed to exit within 5s at shutdown",
                              RuntimeWarning)
        with streams.on(tick_stream):
            # rehydrate any still-down PS so the returned packed state is the
            # best surviving copy and a subsequent run starts healthy
            for s in self.emb.down_shards():
                self.emb.recover_shard(s, reason="shutdown rehydrate")
                self.membership.note("ps_recover", -1,
                                     f"embedding shard {s} rehydrated at shutdown")
            final_fg_sync = False
            if self._sync_degraded and self.membership.active_ids().size > 0:
                # degradation ladder's last rung: one FOREGROUND sync
                n = _round_over_active()
                if n:
                    _add_syncs(n)
                    final_fg_sync = True
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if self._trainer_excs:
            i, e = self._trainer_excs[0]
            others = len(self._trainer_excs) - 1
            raise RuntimeError(
                f"trainer thread (slot {i}) died with {type(e).__name__}: {e}"
                + (f"; {others} more trainer exception(s) captured" if others else "")) from e
        total_iters = sum(self.iter_count)
        planes = [streams.consume(p) for p in self.w]
        w_out = [self.flat.unpack(p) for p in planes] if self.engine == "flat" else planes
        return {
            "eps": self.examples / wall,
            # rate over the trailing window: after a crash, the survivors' pace
            "eps_window": self.eps_meter.eps,
            "wall_s": wall,
            "train_loss": [float(np.mean(l[-50:])) if l else float("nan") for l in losses],
            "sync_count": self.sync_count,
            "avg_sync_gap": total_iters / max(self.sync_count, 1),
            "per_trainer_eps": [
                self.B * self.iter_count[i] / trainer_wall[i]
                if trainer_wall[i] > 0 and self.iter_count[i] > 0 else 0.0
                for i in range(self.R)],
            # intrinsic (busy-clock) pace per slot; barrier waits excluded
            "per_trainer_eps_busy": [
                self.B * self.iter_count[i] / self.slot_eps.busy(i)
                if self.slot_eps.busy(i) > 0 else 0.0
                for i in range(self.R)],
            "iter_count": list(self.iter_count),
            "membership_events": list(self.membership.events),
            "policy_transitions": list(self.policy.transitions) if self.policy is not None else [],
            "supervision_events": list(sup.events) if sup is not None else [],
            "shard_events": list(self.emb.events),
            "dropped_updates": list(self.emb.dropped_updates),
            "stale_lookups": list(self.emb.stale_lookups),
            "cache_stats": self.emb.cache_stats() if self.cache is not None else {},
            "pipeline_stats": self._merged_pipe_stats() if self.pipeline is not None else {},
            "mode": self._mode,
            "mode_transitions": (list(self.mode_ctl.transitions)
                                 if self.mode_ctl is not None else []),
            "sync_rounds": self._shadow_rounds,
            "sync_restarts": sync_restarts,
            "sync_count_at_restart": list(self._sync_count_at_restart),
            "sync_degraded": self._sync_degraded,
            "final_foreground_sync": final_fg_sync,
            "t_start": t0,
            "w": w_out,
            # Engine-independent packed view of the per-PS states.
            "emb_state": self.emb.to_packed(),
        }
