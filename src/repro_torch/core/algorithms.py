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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
