"""Pluggable sync-algorithm API, the twin of ``repro/core/algorithms.py``.

A ``SyncAlgorithm`` bundles an algorithm's lifecycle for both sync engines,
and the registry (``register`` / ``get`` / ``names``) is the only dispatch
point: the runners (core/runners.py) and the launcher know no algorithm by
name. The built-ins are EASGD (paper Algorithm 2), MA (Algorithm 3), BMUF
(Algorithm 4) and Gossip (pairwise averaging). The hooks:

* ``init_state(w0, cfg)`` / ``init_state_flat(plane0, cfg, fs)`` — per-run
  algorithm state (EASGD: the sync-PS copy; BMUF: ``BMUFState``; Gossip:
  the round counter, a Python int; MA: None).
* ``land(stack, state, snap, mask, cfg)`` — the tree oracle. ``snap`` is the
  launch snapshot (None: sync against the current stack), ``mask`` the
  fired-replica mask (None: all).
* ``land_elastic(...)`` — the membership-aware tree landing.
* ``launch_snapshot_flat(buf, mask, cfg, fs, state, active)`` /
  ``land_flat(..., active)`` — the flat engine. The base class routes them
  through the oracle; the built-ins override them with their kernels
  (kernels/{easgd,ma,bmuf,gossip}_update).
* ``make_shadow_round(cfg, fs)`` — ``ThreadedShadowRunner``'s background
  round over the live per-trainer planes (flat) or trees (pytree). Its
  planes are out of place: trainer threads may still read the old ones.
* ``make_sync_step(cfg)`` — the LM trainer's background program
  (``core/spmd.py``): one ``land`` over the whole replica stack.
* ``on_join`` / ``on_join_flat`` / ``on_leave`` / ``on_leave_flat`` — the
  elastic hooks both runners call when a slot joins or leaves;
  ``join_plane_flat`` — the joiner's plane alone, which ``on_join_flat``
  writes into the stack and the threaded runner publishes as it is.

Elastic membership: every hook that launches or lands a sync takes an
``active`` mask (host numpy, from ``core.membership.Membership``). On the
flat engine the live row ids go to the kernels, so dead slots are never read
or written and the means divide by the live count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import sync as S
from repro_torch.core.flatspace import FlatSpace
from repro_torch.kernels import backend
from repro_torch.kernels.bmuf_update import ops as bmuf_ops
from repro_torch.kernels.easgd_update import ops as easgd_ops
from repro_torch.kernels.gossip_update import ops as gossip_ops
from repro_torch.kernels.ma_update import ops as ma_ops

Tree = Any


def _fired_ids(mask, R: int) -> np.ndarray:
    return np.arange(R) if mask is None else np.flatnonzero(np.asarray(mask))


def _intersect(mask, active):
    """Host-level AND of two optional (R,) bool masks (None == all-true)."""
    if active is None:
        return mask
    if mask is None:
        return np.asarray(active, bool)
    return np.asarray(mask, bool) & np.asarray(active, bool)


def _active_rows(active, device) -> torch.Tensor:
    """(A,) int32 live row ids on ``device``, for the rows kernels."""
    return backend.index_tensor(np.flatnonzero(np.asarray(active)), device)


def _gather(buf: torch.Tensor, ids) -> torch.Tensor:
    """A COPY of the listed replica planes (index_select, never a view): the
    round kernel updates ``buf`` in place and must not see its snapshot move."""
    return buf.index_select(0, torch.as_tensor(ids, dtype=torch.long, device=buf.device))


def _stack_planes(ws: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(ws)


def _stack_trees(ws: List[Tree]) -> Tree:
    return T.map(lambda *xs: torch.stack(xs), *ws)


class SyncAlgorithm:
    """Base strategy. Subclasses MUST implement ``land`` and set ``name``; the
    flat hooks default to unpack -> oracle -> pack, so an algorithm that
    only writes the oracle runs on every engine."""

    name: str = ""
    centralized: bool = False

    def init_state(self, w0: Tree, cfg: S.SyncConfig) -> Any:
        return None

    def land(self, stack: Tree, state: Any, snap: Optional[Tree], mask,
             cfg: S.SyncConfig) -> Tuple[Tree, Any]:
        raise NotImplementedError

    def land_elastic(self, stack: Tree, state: Any, snap: Optional[Tree], mask, active,
                     cfg: S.SyncConfig, launch_active=None) -> Tuple[Tree, Any]:
        """Membership-aware tree landing. ``mask`` is the fired mask,
        ``active`` the membership mask NOW and ``launch_active`` the one when
        the sync launched (host numpy or None; None == all slots). Default:
        intersect the fired mask with both and delegate to ``land``, which is
        right for algorithms that respect ``mask``. The mean built-ins
        override it to divide by the live count and land only on live rows;
        Gossip draws its matching over the launch-time live set."""
        eff = _intersect(_intersect(mask, launch_active), active)
        return self.land(stack, state, snap, eff, cfg)

    def init_state_flat(self, plane0: torch.Tensor, cfg: S.SyncConfig, fs: FlatSpace) -> Any:
        return self.init_state(fs.unpack(plane0), cfg)

    def launch_snapshot_flat(self, buf: torch.Tensor, mask, cfg: S.SyncConfig, fs: FlatSpace,
                             state: Any = None, active=None) -> Any:
        """Fallback: one contiguous copy of the whole replica buffer.
        ``state`` is the algorithm state at launch (Gossip picks its pairs
        from it); ``active`` the membership mask at launch."""
        return buf.clone()

    def land_flat(self, buf: torch.Tensor, state: Any, snap, mask, cfg: S.SyncConfig,
                  fs: FlatSpace, active=None) -> Tuple[torch.Tensor, Any]:
        """Fallback: unpack -> tree oracle (the membership-aware one when
        ``active`` is given) -> repack."""
        stack = fs.unpack_stack(buf)
        snap_t = fs.unpack_stack(snap) if snap is not None else None
        if active is None:
            new, state = self.land(stack, state, snap_t, mask, cfg)
        else:
            new, state = self.land_elastic(stack, state, snap_t, mask, active, cfg)
        return fs.pack_stack(new), state

    # -- elastic membership lifecycle ----------------------------------------
    def on_join(self, stack: Tree, slot: int, state: Any, active,
                cfg: S.SyncConfig) -> Tuple[Tree, Any]:
        """Bootstrap a joining replica slot from the live cohort (pytree
        engine). ``active`` is the membership mask BEFORE the join; the new
        slot is not yet in it. Default: the live replica mean."""
        mean = S.masked_replica_mean(stack, active)
        return S.tree_set(stack, slot, mean), state

    def on_join_flat(self, buf: torch.Tensor, slot: int, state: Any, active,
                     cfg: S.SyncConfig, fs: FlatSpace) -> Tuple[torch.Tensor, Any]:
        """Flat-engine join bootstrap: ``join_plane_flat`` into the joiner's
        plane. Out of place."""
        plane, state = self.join_plane_flat(buf, state, active, cfg, fs)
        buf = buf.clone()
        buf[slot] = plane
        return buf, state

    def join_plane_flat(self, buf: torch.Tensor, state: Any, active, cfg: S.SyncConfig,
                        fs: FlatSpace) -> Tuple[torch.Tensor, Any]:
        """A joiner's new plane (a fresh tensor) and the algorithm state.
        Default: the live-mean kernel (K5, ``replica_mean_rows``) over the
        rows of ``buf`` that ``active`` marks; no other row is read."""
        return ma_ops.replica_mean_rows_op(buf, _active_rows(active, buf.device)), state

    def on_leave(self, state: Any, slot: int, cfg: S.SyncConfig) -> Any:
        """Drop a departing slot from algorithm state. No built-in keeps
        per-replica state, so the default keeps ``state`` unchanged."""
        return state

    def on_leave_flat(self, state: Any, slot: int, cfg: S.SyncConfig, fs: FlatSpace) -> Any:
        return self.on_leave(state, slot, cfg)

    # -- ThreadedShadowRunner background round --------------------------------
    def make_shadow_round(self, cfg: S.SyncConfig,
                          fs: Optional[FlatSpace]) -> Callable[[List, Any], Tuple[Any, int]]:
        """Returns round(ws, state) -> (state, n_syncs); replaces the entries of
        ``ws`` (the per-trainer planes or trees) with new ones. Fallback:
        stack, land against the current state (no snapshot: the threaded
        shadow reads live), and slice back."""
        if fs is not None:
            def rnd(ws, state):
                buf, state = self.land_flat(_stack_planes(ws), state, None, None, cfg, fs)
                for i in range(len(ws)):
                    ws[i] = buf[i]
                return state, 1
        else:
            def rnd(ws, state):
                new, state = self.land(_stack_trees(ws), state, None, None, cfg)
                for i in range(len(ws)):
                    ws[i] = S.tree_slice(new, i)
                return state, 1
        return rnd

    # -- LM trainer background program ----------------------------------------
    def make_sync_step(self, cfg: S.SyncConfig) -> Callable:
        """``sync_step(stack, algo_state=None) -> (stack, algo_state)``: every
        replica fired, against the current stack (no launch snapshot). One
        signature for every algorithm (``algo_state`` is ``init_state``'s)."""
        def sync_step(stack, algo_state=None):
            return self.land(stack, algo_state, None, None, cfg)

        return sync_step


_REGISTRY: Dict[str, SyncAlgorithm] = {}


def register(algo, *, override: bool = False):
    """Register an algorithm instance (or class, instantiated with no args).
    Usable as a class decorator."""
    cls = algo if isinstance(algo, type) else None
    if cls is not None:
        algo = cls()
    if not algo.name:
        raise ValueError(f"{type(algo).__name__} must set a non-empty .name")
    if algo.name in _REGISTRY and not override:
        raise ValueError(
            f"sync algorithm {algo.name!r} already registered (pass override=True to replace)")
    _REGISTRY[algo.name] = algo
    return cls if cls is not None else algo


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get(name: str) -> SyncAlgorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sync algorithm {name!r}; registered: {list(names())}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# EASGD (centralized; paper Algorithm 2)
# ---------------------------------------------------------------------------

@register
class EASGD(SyncAlgorithm):
    name = "easgd"
    centralized = True

    def init_state(self, w0, cfg):
        return T.map(torch.clone, w0)  # the sync-PS copy

    def land(self, stack, state, snap, mask, cfg):
        return S.easgd_round(stack, state, cfg.alpha, mask=mask, snapshot=snap)

    def init_state_flat(self, plane0, cfg, fs):
        return plane0.clone()  # (n_rows, 128) fp32 PS plane

    def launch_snapshot_flat(self, buf, mask, cfg, fs, state=None, active=None):
        """Self-describing snapshot: a compact copy of the fired live rows
        PLUS their ids, so a slot that dies while the sync is in flight can
        be dropped at landing."""
        fired = _fired_ids(_intersect(mask, active), buf.shape[0])
        return _gather(buf, fired), tuple(int(i) for i in fired)

    def land_flat(self, buf, state, snap, mask, cfg, fs, active=None):
        if snap is None:  # fixed-rate: gather from the current buffer first,
            # since the round updates ``buf`` in place
            ids = _fired_ids(_intersect(mask, active), buf.shape[0])
            snap = (_gather(buf, ids), tuple(int(i) for i in ids))
        snap_rows, ids = snap
        ids = np.asarray(ids, np.int64)
        # a slot that died mid-flight neither moves the PS nor lands
        keep = np.ones(ids.shape, bool) if active is None else np.asarray(active, bool)[ids]
        if not keep.any():
            return buf, state
        if not keep.all():
            snap_rows = _gather(snap_rows, np.flatnonzero(keep))
            ids = ids[keep]
        fired = backend.index_tensor(ids, buf.device)
        return easgd_ops.easgd_round_op(buf, state, snap_rows, fired, cfg.alpha)

    def on_join(self, stack, slot, state, active, cfg):
        # a joiner adopts the sync-PS copy: the centralized consensus point
        return S.tree_set(stack, slot, state), state

    def join_plane_flat(self, buf, state, active, cfg, fs):
        return state.clone(), state

    def make_shadow_round(self, cfg, fs):
        if fs is not None:
            def pair(ps, w):
                return easgd_ops.easgd_pair_flat_op(ps, w, cfg.alpha)
        else:
            def pair(ps, w):
                return S.easgd_pair_update(ps, w, cfg.alpha)

        def rnd(ws, state):
            # shadow threads reach the PS one replica at a time (Algorithm 2)
            for i in range(len(ws)):
                state, ws[i] = pair(state, ws[i])
            return state, len(ws)

        return rnd


# ---------------------------------------------------------------------------
# Model Averaging and BMUF (decentralized; paper Algorithms 3 and 4)
# ---------------------------------------------------------------------------

def _mean_snapshot(buf: torch.Tensor, active) -> torch.Tensor:
    """The decentralized launch snapshot: the replica mean (of the live
    rows under elastic membership), one kernel launch."""
    if active is None:
        return ma_ops.replica_mean_op(buf)
    return ma_ops.replica_mean_rows_op(buf, _active_rows(active, buf.device))


def _pull_back_planes(ws: List[torch.Tensor], target: torch.Tensor, alpha: float) -> None:
    """Replace each plane of ``ws`` by a NEW plane pulled toward ``target``:
    one out-of-place pull-back launch per plane, landing on the CURRENT
    plane (trainers kept moving while the mean was in flight, paper §3.3)."""
    for i in range(len(ws)):
        out = torch.empty_like(ws[i])
        ma_ops.ma_sync_op(ws[i].unsqueeze(0), target, alpha, out=out.unsqueeze(0))
        ws[i] = out


@register
class MA(SyncAlgorithm):
    name = "ma"

    def land(self, stack, state, snap, mask, cfg):
        return S.ma_round(stack, cfg.alpha, snapshot=snap), state

    def land_elastic(self, stack, state, snap, mask, active, cfg, launch_active=None):
        if active is None and launch_active is None:
            return super().land_elastic(stack, state, snap, mask, active, cfg)
        # the mean over the LAUNCH-time live set (what the background
        # AllReduce saw); the pull-back lands on the CURRENT live rows
        if launch_active is None:
            launch_active = active
        return S.ma_round(stack, cfg.alpha, snapshot=snap, active=launch_active,
                          land_active=active), state

    def launch_snapshot_flat(self, buf, mask, cfg, fs, state=None, active=None):
        return _mean_snapshot(buf, active)

    def land_flat(self, buf, state, snap, mask, cfg, fs, active=None):
        mean = snap if snap is not None else _mean_snapshot(buf, active)
        if active is None:
            return ma_ops.ma_sync_op(buf, mean, cfg.alpha), state
        return ma_ops.ma_sync_rows_op(buf, mean, _active_rows(active, buf.device),
                                      cfg.alpha), state

    def make_shadow_round(self, cfg, fs):
        if fs is not None:
            def rnd(ws, state):
                # one mean over the stacked planes, then per-plane pull-backs
                _pull_back_planes(ws, ma_ops.replica_mean_op(_stack_planes(ws)), cfg.alpha)
                return state, 1
        else:
            def rnd(ws, state):
                new = S.ma_round(_stack_trees(ws), cfg.alpha)
                for i in range(len(ws)):
                    ws[i] = S.tree_slice(new, i)
                return state, 1
        return rnd


def _bmuf_kw(cfg: S.SyncConfig) -> Dict[str, Any]:
    return dict(eta=cfg.eta, block_momentum=cfg.block_momentum, nesterov=cfg.nesterov)


def _bmuf_plane_step(mean: torch.Tensor, wg: torch.Tensor, vel: torch.Tensor, cfg: S.SyncConfig):
    """The N-sized BMUF global step on flat planes, out of place; returns
    (look, wg', vel')."""
    vel = cfg.block_momentum * vel + cfg.eta * (mean - wg)
    wg = wg + vel
    look = wg + cfg.block_momentum * vel if cfg.nesterov else wg
    return look, wg, vel


@register
class BMUF(SyncAlgorithm):
    name = "bmuf"

    def init_state(self, w0, cfg):
        return S.BMUFState.init(w0)

    def land(self, stack, state, snap, mask, cfg):
        return S.bmuf_round(stack, state, cfg.alpha, snapshot=snap, **_bmuf_kw(cfg))

    def init_state_flat(self, plane0, cfg, fs):
        return S.BMUFState(w_global=plane0.clone(), velocity=torch.zeros_like(plane0))

    def land_elastic(self, stack, state, snap, mask, active, cfg, launch_active=None):
        if active is None and launch_active is None:
            return super().land_elastic(stack, state, snap, mask, active, cfg)
        if launch_active is None:
            launch_active = active
        return S.bmuf_round(stack, state, cfg.alpha, snapshot=snap, active=launch_active,
                            land_active=active, **_bmuf_kw(cfg))

    def launch_snapshot_flat(self, buf, mask, cfg, fs, state=None, active=None):
        return _mean_snapshot(buf, active)

    def land_flat(self, buf, state, snap, mask, cfg, fs, active=None):
        """One in-place launch on the stack, ``w_global`` and ``velocity``
        (the sim owns all three)."""
        mean = snap if snap is not None else _mean_snapshot(buf, active)
        if active is None:
            new, wg, vel = bmuf_ops.bmuf_sync_op(buf, mean, state.w_global, state.velocity,
                                                 cfg.alpha, **_bmuf_kw(cfg))
        else:
            new, wg, vel = bmuf_ops.bmuf_sync_rows_op(
                buf, mean, state.w_global, state.velocity, _active_rows(active, buf.device),
                cfg.alpha, **_bmuf_kw(cfg))
        return new, S.BMUFState(w_global=wg, velocity=vel)

    def make_shadow_round(self, cfg, fs):
        if fs is not None:
            def rnd(ws, state):
                # real block momentum in the background: mean -> N-sized
                # global step (out of place: the runner may discard the
                # round) -> per-plane pull-backs toward the look-ahead
                mean = ma_ops.replica_mean_op(_stack_planes(ws))
                look, wg, vel = _bmuf_plane_step(mean, state.w_global, state.velocity, cfg)
                _pull_back_planes(ws, look, cfg.alpha)
                return S.BMUFState(w_global=wg, velocity=vel), 1
        else:
            def rnd(ws, state):
                new, state = S.bmuf_round(_stack_trees(ws), state, cfg.alpha, **_bmuf_kw(cfg))
                for i in range(len(ws)):
                    ws[i] = S.tree_slice(new, i)
                return state, 1
        return rnd


# ---------------------------------------------------------------------------
# Gossip (decentralized, pairwise, partial participation; ADPSGD-style)
# ---------------------------------------------------------------------------

def _ring_partner_np(R: int, shift: int) -> List[int]:
    """Rotating perfect matching over replica ids 0..R-1.

    Position k of the rotated ring holds id (k + shift) % R; consecutive ring
    positions pair up. Returns ``partner``, an involution; a self-partner is
    unpaired this round (the odd one out when R is odd). Successive shifts
    alternate the matchings, so pairwise averaging mixes globally."""
    order = [(k + shift) % R for k in range(R)]
    partner = list(range(R))
    for k in range(0, R - 1, 2):
        a, b = order[k], order[k + 1]
        partner[a], partner[b] = b, a
    return partner


def _ring_partner(R: int, shift) -> torch.Tensor:
    """``_ring_partner_np`` as an int64 tensor (``shift``: int or counter)."""
    return torch.tensor(_ring_partner_np(R, int(shift)), dtype=torch.long)


def _ring_partner_active_np(active, shift: int) -> List[int]:
    """Rotating matching drawn over the ACTIVE slots only: the ring is formed
    on the live ids, then mapped back to slot numbers. Dead slots are their
    own partner (never paired)."""
    active = np.asarray(active, bool)
    ids = np.flatnonzero(active)
    partner = list(range(active.shape[0]))
    sub = _ring_partner_np(len(ids), shift)
    for k, g in enumerate(ids):
        partner[int(g)] = int(ids[sub[k]])
    return partner


def _gossip_participants_np(mask, R: int, shift: int, active=None):
    """Participant rows of a gossip round (flat-engine operands, host side).

    A ring pair is live when either member's shadow clock fired: the
    initiator pulls its passive partner into the exchange (ADPSGD), so a
    round with a single fired replica still syncs. Under elastic membership
    the ring is drawn over the live slots only. Returns (rows, self_pos,
    partner_pos): the sorted ids of every live pair's members (the rows the
    launch snapshot gathers and that land) and each one's own and partner's
    position inside that snapshot."""
    m = np.ones((R,), bool) if mask is None else np.asarray(mask).astype(bool)
    if active is None:
        partner = _ring_partner_np(R, shift)
    else:
        partner = _ring_partner_active_np(active, shift)
        m = m & np.asarray(active, bool)
    rows = [i for i in range(R) if partner[i] != i and (m[i] or m[partner[i]])]
    pos = {rid: k for k, rid in enumerate(rows)}
    return rows, [pos[i] for i in rows], [pos[partner[i]] for i in rows]


def _gossip_land(stack: Tree, src: Tree, partner: np.ndarray, live: np.ndarray,
                 alpha: float) -> Tree:
    """Each live row pulled toward its pair's mix of ``src``; others kept."""
    idx = torch.as_tensor(partner, dtype=torch.long)

    def leaf(x, x_snap):
        xs = x_snap.float()
        mix = 0.5 * (xs + xs[idx.to(xs.device)])
        new = (1.0 - alpha) * x.float() + alpha * mix
        return torch.where(S._bc_mask(live, x), new, x.float()).to(x.dtype)

    return T.map(leaf, stack, src)


@register
class Gossip(SyncAlgorithm):
    name = "gossip"

    def init_state(self, w0, cfg):
        return 0  # the round counter drives the pair rotation (a host int)

    def init_state_flat(self, plane0, cfg, fs):
        return self.init_state(None, cfg)

    def land(self, stack, state, snap, mask, cfg):
        R = T.leaves(stack)[0].shape[0]
        m = np.ones((R,), bool) if mask is None else np.asarray(mask, bool)
        partner = np.asarray(_ring_partner_np(R, int(state)))
        # a pair is live when EITHER member fired
        live = (partner != np.arange(R)) & (m | m[partner])
        src = snap if snap is not None else stack
        return _gossip_land(stack, src, partner, live, cfg.alpha), state + 1

    def land_elastic(self, stack, state, snap, mask, active, cfg, launch_active=None):
        if active is None and launch_active is None:
            return super().land_elastic(stack, state, snap, mask, active, cfg)
        if launch_active is None:
            launch_active = active
        # the matching was drawn at LAUNCH, over the then-live slots; the
        # landing touches only rows that are STILL live (a slot that died
        # mid-flight is skipped, its partner still lands from the snapshot)
        partner = np.asarray(_ring_partner_active_np(launch_active, int(state)))
        m = np.asarray(launch_active if mask is None else mask, bool)
        live = (partner != np.arange(partner.shape[0])) & (m | m[partner])
        if active is not None:
            live = live & np.asarray(active, bool)
        src = snap if snap is not None else stack
        return _gossip_land(stack, src, partner, live, cfg.alpha), state + 1

    def launch_snapshot_flat(self, buf, mask, cfg, fs, state=None, active=None):
        """Self-describing snapshot: a compact copy of exactly the live-pair
        members' rows PLUS the pairing that produced it, so the landing never
        re-derives the participants from state that moved in flight."""
        rows, self_pos, partner_pos = _gossip_participants_np(
            mask, buf.shape[0], 0 if state is None else int(state), active=active)
        return _gather(buf, rows), rows, self_pos, partner_pos

    def land_flat(self, buf, state, snap, mask, cfg, fs, active=None):
        if snap is None:  # fixed-rate: pair and gather at landing time (the
            # round updates ``buf`` in place, so the snapshot is a copy)
            snap = self.launch_snapshot_flat(buf, mask, cfg, fs, state, active=active)
        snap_rows, rows, self_pos, partner_pos = snap
        new_state = state + 1
        if active is not None and rows:
            # a slot that died mid-flight is skipped; its live partner still
            # lands from the snapshot mix gathered at launch
            act = np.asarray(active, bool)
            kept = [k for k, rid in enumerate(rows) if act[rid]]
            rows = [rows[k] for k in kept]
            self_pos = [self_pos[k] for k in kept]
            partner_pos = [partner_pos[k] for k in kept]
        if not rows:
            return buf, new_state
        dev = buf.device
        new = gossip_ops.gossip_round_op(
            buf, snap_rows, backend.index_tensor(rows, dev), backend.index_tensor(self_pos, dev),
            backend.index_tensor(partner_pos, dev), cfg.alpha)
        return new, new_state

    def make_shadow_round(self, cfg, fs):
        if fs is not None:
            def pair(a, b):
                return gossip_ops.gossip_pair_flat_op(a, b, cfg.alpha)
        else:
            def pair(a, b):
                mix = T.map(lambda x, y: 0.5 * (x.float() + y.float()), a, b)
                return S.lerp(a, mix, cfg.alpha), S.lerp(b, mix, cfg.alpha)

        def rnd(ws, state):
            partner = _ring_partner_np(len(ws), int(state))
            for i in range(len(ws)):
                if partner[i] > i:  # exchange each pair once
                    ws[i], ws[partner[i]] = pair(ws[i], ws[partner[i]])
            return state + 1, 1

        return rnd
