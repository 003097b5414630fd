"""The activation-sharding context (the twin of ``repro/sharding/ctx.py``),
a no-op on one device.

The reference's model code calls ``constrain(x, ("batch", None, "model"))``
with logical axis tokens; under ``activation_mesh`` those become
``with_sharding_constraint`` hints for its partitioner. The port computes on
one card with no partitioner, so ``constrain`` returns ``x`` unchanged,
always. ``resolve`` gives the placement the reference would ask for, token
by token: "batch" -> the batch mesh axes, "model" -> the tensor-parallel
axis, None -> unconstrained, and an axis the dim does not divide is dropped.

The port's MoE routes every token in one dispatch group: on one card there
is one data shard, which is what the reference's ``_n_groups`` gives with no
mesh (``repro/models/moe.py:39-46``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

_tls = threading.local()


@dataclass
class _Ctx:
    mesh: object  # a launch.mesh.Mesh
    batch_axes: Tuple[str, ...]
    model_axis: str


@contextlib.contextmanager
def activation_mesh(mesh, *, batch_axes: Sequence[str] = ("data",), model_axis: str = "model"):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = _Ctx(mesh, tuple(batch_axes), model_axis)
    try:
        yield
    finally:
        _tls.ctx = prev


def active() -> Optional[_Ctx]:
    return getattr(_tls, "ctx", None)


def _axis_size(mesh, ax) -> int:
    shape = mesh.shape
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


def resolve(shape, spec: Sequence) -> Optional[tuple]:
    """The resolved spec of an activation of ``shape`` under the active
    context (None without one), as the reference's ``constrain`` builds its
    ``PartitionSpec``."""
    ctx = active()
    if ctx is None:
        return None
    assert len(spec) == len(shape), (spec, shape)
    resolved = []
    for dim, s in zip(shape, spec):
        if s == "batch":
            ax = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
        elif s == "model":
            ax = ctx.model_axis
        else:
            ax = s
        if ax is not None and (dim < _axis_size(ctx.mesh, ax) or dim % _axis_size(ctx.mesh, ax)):
            ax = None
        resolved.append(ax)
    return tuple(resolved)


def constrain(x, spec: Sequence):
    """``x`` itself: one card has nothing to place."""
    return x
