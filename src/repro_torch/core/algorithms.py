"""Pluggable sync-algorithm API, the twin of ``repro/core/algorithms.py``.

A ``SyncAlgorithm`` bundles an algorithm's lifecycle for both sync engines,
and the registry (``register`` / ``get`` / ``names``) is the only dispatch
point: the runner (core/runners.py) and the launcher know no algorithm by
name. The hooks ported so far are those ``HogwildSim``'s plain path calls:

* ``init_state(w0, cfg)`` / ``init_state_flat(plane0, cfg, fs)`` — per-run
  algorithm state (EASGD: the sync-PS copy).
* ``land(stack, state, snap, mask, cfg)`` — the tree oracle. ``snap`` is the
  launch snapshot (None: sync against the current stack), ``mask`` the
  fired-replica mask (None: all).
* ``launch_snapshot_flat(buf, mask, cfg, fs, state)`` / ``land_flat(...)`` —
  the flat engine. The base class routes them through the oracle; EASGD
  overrides them with its kernel (kernels/easgd_update).
* ``make_shadow_round(cfg, fs)`` — ``ThreadedShadowRunner``'s background
  round over the live per-trainer planes (flat) or trees (pytree). EASGD's
  is one out-of-place pair-kernel launch per replica.
* ``on_join`` / ``on_join_flat`` / ``on_leave`` / ``on_leave_flat`` — the
  elastic hooks the threaded runner calls when a slot joins or leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import sync as S
from repro_torch.core.flatspace import FlatSpace
from repro_torch.kernels.easgd_update import ops as easgd_ops

Tree = Any


def _fired_ids(mask, R: int) -> np.ndarray:
    return np.arange(R) if mask is None else np.flatnonzero(np.asarray(mask))


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
    flat hooks default to unpack -> oracle -> pack."""

    name: str = ""
    centralized: bool = False

    def init_state(self, w0: Tree, cfg: S.SyncConfig) -> Any:
        return None

    def land(self, stack: Tree, state: Any, snap: Optional[Tree], mask,
             cfg: S.SyncConfig) -> Tuple[Tree, Any]:
        raise NotImplementedError

    def init_state_flat(self, plane0: torch.Tensor, cfg: S.SyncConfig, fs: FlatSpace) -> Any:
        return self.init_state(fs.unpack(plane0), cfg)

    def launch_snapshot_flat(self, buf: torch.Tensor, mask, cfg: S.SyncConfig, fs: FlatSpace,
                             state: Any = None) -> Any:
        """Fallback: one contiguous copy of the whole replica buffer."""
        return buf.clone()

    def land_flat(self, buf: torch.Tensor, state: Any, snap, mask, cfg: S.SyncConfig,
                  fs: FlatSpace) -> Tuple[torch.Tensor, Any]:
        """Fallback: unpack -> tree oracle -> repack."""
        snap_t = fs.unpack_stack(snap) if snap is not None else None
        new, state = self.land(fs.unpack_stack(buf), state, snap_t, mask, cfg)
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
        """Flat-engine join bootstrap. The default is the live-mean kernel
        (K5, ``ma_update.replica_mean_rows``), which is not ported yet; no
        registered algorithm reaches this."""
        raise NotImplementedError(
            f"{type(self).__name__}.on_join_flat needs the live replica-mean kernel "
            "ma_update.replica_mean_rows (K5), not yet ported")

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


@register
class EASGD(SyncAlgorithm):
    """Centralized elastic averaging (paper Algorithm 2)."""

    name = "easgd"
    centralized = True

    def init_state(self, w0, cfg):
        return T.map(torch.clone, w0)  # the sync-PS copy

    def land(self, stack, state, snap, mask, cfg):
        return S.easgd_round(stack, state, cfg.alpha, mask=mask, snapshot=snap)

    def init_state_flat(self, plane0, cfg, fs):
        return plane0.clone()  # (n_rows, 128) fp32 PS plane

    def launch_snapshot_flat(self, buf, mask, cfg, fs, state=None):
        """A compact copy of the fired rows PLUS their ids."""
        fired = _fired_ids(mask, buf.shape[0])
        return _gather(buf, fired), tuple(int(i) for i in fired)

    def land_flat(self, buf, state, snap, mask, cfg, fs):
        if snap is None:  # fixed-rate: gather from the current buffer first,
            # since the round updates ``buf`` in place
            ids = _fired_ids(mask, buf.shape[0])
            snap = (_gather(buf, ids), ids)
        snap_rows, ids = snap
        if len(ids) == 0:
            return buf, state
        fired = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=buf.device)
        return easgd_ops.easgd_round_op(buf, state, snap_rows, fired, cfg.alpha)

    def on_join(self, stack, slot, state, active, cfg):
        # a joiner adopts the sync-PS copy: the centralized consensus point
        return S.tree_set(stack, slot, state), state

    def on_join_flat(self, buf, slot, state, active, cfg, fs):
        buf = buf.clone()
        buf[slot] = state
        return buf, state

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
