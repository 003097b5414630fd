"""ShadowSync synchronization math over parameter trees (paper Algorithm 2),
the twin of ``repro/core/sync.py``, and the sync configuration.

Shadow and fixed-rate (FR) modes share these updates; what differs is when
and from which snapshot they are applied (core/runners.py). Replica stacks
are trees whose leaves carry a leading replica dim R. These pure functions
are the numerical oracle of the flat engine's kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as T

Tree = Any


def lerp(a: Tree, b: Tree, alpha: float) -> Tree:
    """(1-alpha) * a + alpha * b, leafwise, in fp32."""
    return T.map(lambda x, y: ((1.0 - alpha) * x.float() + alpha * y.float()).to(x.dtype), a, b)


def replica_mean(stack: Tree) -> Tree:
    return T.map(lambda x: x.float().mean(0), stack)


def masked_replica_mean(stack: Tree, active) -> Tree:
    """Mean over only the ACTIVE replicas (the elastic-membership
    denominator: dead slots contribute nothing, the mean divides by the live
    count). ``active``: (R,) bool."""
    def mean(x):
        m = torch.as_tensor(active, dtype=torch.bool, device=x.device)
        m = m.reshape((-1,) + (1,) * (x.dim() - 1))
        cnt = max(float(m.sum()), 1.0)
        return torch.where(m, x.float(), 0.0).sum(0) / cnt

    return T.map(mean, stack)


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
