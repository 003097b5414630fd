"""ShadowSync synchronization math over parameter trees (paper Algorithms 2-4),
the twin of ``repro/core/sync.py``, and the sync configuration.

Shadow and fixed-rate (FR) modes share these updates; what differs is when
and from which snapshot they are applied (core/runners.py). Replica stacks
are trees whose leaves carry a leading replica dim R. These pure functions
are the numerical oracle of the flat engine's kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

Tree = Any


def lerp(a: Tree, b: Tree, alpha: float) -> Tree:
    """(1-alpha) * a + alpha * b, leafwise, in fp32."""
    return T.map(lambda x, y: ((1.0 - alpha) * x.float() + alpha * y.float()).to(x.dtype), a, b)


def replica_mean(stack: Tree) -> Tree:
    return T.map(lambda x: x.float().mean(0), stack)


def _bc_mask(mask, x: torch.Tensor) -> torch.Tensor:
    """A (R,) bool mask (numpy, list or tensor) on ``x``'s device, broadcast
    over a leaf with leading replica dim."""
    m = torch.as_tensor(np.asarray(mask, dtype=bool), device=x.device)
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


def masked_replica_mean(stack: Tree, active) -> Tree:
    """Mean over only the ACTIVE replicas (the elastic-membership
    denominator: dead slots contribute nothing, the mean divides by the live
    count). ``active``: (R,) bool."""
    cnt = max(float(np.asarray(active, dtype=bool).sum()), 1.0)

    def mean(x):
        return torch.where(_bc_mask(active, x), x.float(), 0.0).sum(0) / cnt

    return T.map(mean, stack)


def _land_rows(new: Tree, old: Tree, land_active) -> Tree:
    """``new`` on the rows of ``land_active``, ``old`` elsewhere."""
    return T.map(lambda n, x: torch.where(_bc_mask(land_active, x), n, x), new, old)


def tree_slice(stack: Tree, i) -> Tree:
    return T.map(lambda x: x[i], stack)


def tree_set(stack: Tree, i, val: Tree) -> Tree:
    """Out of place: a new stack with replica ``i`` replaced by ``val``."""
    def put(x, v):
        x = x.clone()
        x[i] = v.to(x.dtype)
        return x

    return T.map(put, stack, val)


def easgd_pair_update(w_ps: Tree, w_i: Tree, alpha: float) -> Tuple[Tree, Tree]:
    """One shadow-EASGD exchange between the sync-PS copy and replica i: the
    PS moves toward the replica, then the replica toward the UPDATED PS."""
    new_ps = lerp(w_ps, w_i, alpha)
    return new_ps, lerp(w_i, new_ps, alpha)


def easgd_round(w_stack: Tree, w_ps: Tree, alpha: float, mask: Optional[torch.Tensor] = None,
                snapshot: Optional[Tree] = None) -> Tuple[Tree, Tree]:
    """Sequential EASGD over the replicas (shadow threads reach the PS one at a
    time). ``mask[i]`` selects which replicas' shadow clocks fired. ``snapshot``
    (if given) is the stack at sync launch: the PS moves toward it while the
    pull-back lands on the current replica. Out of place."""
    R = T.leaves(w_stack)[0].shape[0]
    fired = range(R) if mask is None else [i for i in range(R) if bool(mask[i])]
    snap = snapshot if snapshot is not None else w_stack
    rows = {}
    for i in fired:
        w_ps = lerp(w_ps, tree_slice(snap, i), alpha)
        rows[i] = lerp(tree_slice(w_stack, i), w_ps, alpha)

    def land(x, *new):
        x = x.clone()
        for i, v in zip(rows, new):
            x[i] = v
        return x

    return T.map(land, w_stack, *rows.values()), w_ps


# ---------------------------------------------------------------------------
# Model Averaging (decentralized; Algorithm 3)
# ---------------------------------------------------------------------------

def ma_round(w_stack: Tree, alpha: float, snapshot: Optional[Tree] = None, active=None,
             land_active=None) -> Tree:
    """AllReduce-average the replicas, then elastically pull each replica
    toward the average. ``snapshot`` (if given) is the stack at sync launch:
    the average comes from it while the pull-back lands on the current stack.

    Elastic membership: ``active`` ((R,) bool) restricts the MEAN to the
    replicas live at launch (divide by the live count); ``land_active``
    restricts the pull-back to the replicas live at landing (defaults to
    ``active``; dead slots are untouched either way). Out of place."""
    src = snapshot if snapshot is not None else w_stack
    w_global = replica_mean(src) if active is None else masked_replica_mean(src, active)
    new = lerp(w_stack, T.map(lambda g, x: g.to(x.dtype).expand_as(x), w_global, w_stack), alpha)
    if land_active is None:
        land_active = active
    if land_active is None:
        return new
    return _land_rows(new, w_stack, land_active)


# ---------------------------------------------------------------------------
# BMUF (decentralized; Algorithm 4)
# ---------------------------------------------------------------------------

@dataclass
class BMUFState:
    """BMUF's state: a dataclass of two trees, mapped field by field by
    ``tree.map`` (the twin of the reference's registered dataclass)."""

    w_global: Tree
    velocity: Tree  # block momentum buffer

    @staticmethod
    def init(w0: Tree) -> "BMUFState":
        return BMUFState(w_global=T.map(lambda x: x.float().clone(), w0),
                         velocity=T.map(lambda x: torch.zeros_like(x, dtype=torch.float32), w0))


def bmuf_round(w_stack: Tree, state: BMUFState, alpha: float, *, eta: float = 1.0,
               block_momentum: float = 0.0, nesterov: bool = False, step_scale_n: bool = False,
               snapshot: Optional[Tree] = None, active=None,
               land_active=None) -> Tuple[Tree, BMUFState]:
    """Algorithm 4. AllReduce-average -> descent direction against w_global
    -> (optional block-momentum / Nesterov) global step -> elastic pull-back
    into each replica. ``active`` restricts the mean to the replicas live at
    launch, ``land_active`` the pull-back to those live at landing (defaults
    to ``active``); the global step has no replica axis.

    ``step_scale_n=True`` is the paper's line 9 literally (w_global += n *
    w_desc); the default is the classic BMUF block step (scale 1), as in the
    reference. Out of place."""
    R = T.leaves(w_stack)[0].shape[0]
    src = snapshot if snapshot is not None else w_stack
    w_copy = replica_mean(src) if active is None else masked_replica_mean(src, active)
    desc = T.map(lambda c, g: c - g, w_copy, state.w_global)
    scale = float(R) if step_scale_n else 1.0
    vel = T.map(lambda v, d: block_momentum * v + eta * scale * d, state.velocity, desc)
    w_global = T.map(lambda g, v: g + v, state.w_global, vel)
    look = T.map(lambda g, v: g + block_momentum * v, w_global, vel) if nesterov else w_global
    new = lerp(w_stack, T.map(lambda g, x: g.to(x.dtype).expand_as(x), look, w_stack), alpha)
    if land_active is None:
        land_active = active
    if land_active is not None:
        new = _land_rows(new, w_stack, land_active)
    return new, BMUFState(w_global=w_global, velocity=vel)


@dataclass(frozen=True)
class SyncConfig:
    algo: str = "easgd"  # any name in core.algorithms.names()
    alpha: float = 0.5
    # shadow mode: sync fires per replica every `gap` iterations with staggered
    # offsets; FR mode: foreground, all replicas at t % gap == 0.
    mode: str = "shadow"  # shadow | fixed_rate
    gap: int = 5
    # iterations of training that elapse while a background sync is in flight;
    # the sync reads the snapshot taken at launch, lands `delay` iterations later.
    delay: int = 1
    eta: float = 1.0
    block_momentum: float = 0.0
    nesterov: bool = False
    # "flat": replicas live in a persistent (R, n_rows, 128) fp32 buffer
    # (core/flatspace.py) and a sync is one kernel launch; "pytree": the tree
    # math above, kept as the oracle.
    engine: str = "flat"  # flat | pytree

    def centralized(self) -> bool:
        from repro_torch.core import algorithms  # deferred: algorithms imports us
        return algorithms.get(self.algo).centralized

    def validate(self) -> "SyncConfig":
        from repro_torch.core import algorithms  # deferred: algorithms imports us
        if self.algo not in algorithms.names():
            raise ValueError(
                f"unknown sync algo: {self.algo!r}; registered: {list(algorithms.names())}")
        if self.engine not in ("flat", "pytree"):
            raise ValueError(f"unknown sync engine: {self.engine!r}")
        if self.mode not in ("shadow", "fixed_rate"):
            raise ValueError(f"unknown sync mode: {self.mode!r}")
        if self.gap < 1:
            raise ValueError(
                f"gap must be >= 1 (iterations between shadow-clock fires), got {self.gap}")
        if self.delay < 0:
            raise ValueError(
                f"delay must be >= 0 (in-flight iterations of a background "
                f"sync; 0 lands same-iteration), got {self.delay}")
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(
                f"alpha must be in [0, 1] (elastic interpolation weight), got {self.alpha}")
        return self
