"""The activation-sharding context (the twin of ``repro/sharding/ctx.py``).

Model code calls ``constrain(x, ("batch", None, "model"))`` with logical
axis tokens: "batch" -> the batch mesh axes, "model" -> the tensor-parallel
axis, None -> replicated; an axis the dim does not divide is dropped, as the
reference drops it. Under ``activation_mesh`` over a ``DeviceMesh``, a
DTensor ``x`` is redistributed to those placements on its own mesh
(``x.redistribute``): the reference's ``with_sharding_constraint`` hint
becomes the collective DTensor runs for it. Without a context, under a
context over a ``Mesh`` description, and for a plain tensor, ``constrain``
returns ``x`` itself: the one-card program never changes. ``resolve`` gives
the placement the reference would ask for, token by token.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.launch.mesh import is_device_mesh, mesh_shape

_tls = threading.local()


@dataclass
class _Ctx:
    mesh: object  # a launch.mesh.Mesh or a DeviceMesh
    batch_axes: Tuple[str, ...]
    model_axis: str


@contextlib.contextmanager
def activation_mesh(mesh, *, batch_axes: Sequence[str] = ("data",), model_axis: str = "model"):
    """The context model code reads (``constrain``, MoE's dispatch groups).
    Over a ``DeviceMesh``, a plain tensor that meets a DTensor in an op
    (positions, masks, RoPE tables, the loss weights) counts as replicated
    on its mesh (DTensor's ``implicit_replication``)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = _Ctx(mesh, tuple(batch_axes), model_axis)
    try:
        if is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _tls.ctx = prev


def active() -> Optional[_Ctx]:
    return getattr(_tls, "ctx", None)


def on_device_mesh() -> bool:
    """An active context over a ``DeviceMesh``: the mesh program runs."""
    ctx = active()
    return ctx is not None and is_device_mesh(ctx.mesh)


def _axis_size(shape, ax) -> int:
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


def resolve(shape, spec: Sequence, mesh=None) -> Optional[tuple]:
    """The resolved spec of an activation of ``shape`` under the active
    context (None without one), as the reference's ``constrain`` builds its
    ``PartitionSpec``, on ``mesh`` (the context's by default). Batch axes
    that ``mesh`` lacks are left out (a replica's sub-mesh has no "pod")."""
    ctx = active()
    if ctx is None:
        return None
    assert len(spec) == len(shape), (spec, shape)
    sizes = mesh_shape(ctx.mesh if mesh is None else mesh)
    batch = tuple(a for a in ctx.batch_axes if a in sizes)
    resolved = []
    for dim, s in zip(shape, spec):
        if s == "batch":
            ax = (batch if len(batch) > 1 else batch[0]) if batch else None
        elif s == "model":
            ax = ctx.model_axis
        else:
            ax = s
        if ax is not None and (dim < _axis_size(sizes, ax) or dim % _axis_size(sizes, ax)):
            ax = None
        resolved.append(ax)
    return tuple(resolved)


def constrain(x, spec: Sequence):
    """``x`` redistributed to the resolved ``spec`` on its own device mesh,
    when a context over a ``DeviceMesh`` is active and ``x`` is a DTensor;
    otherwise ``x`` itself."""
    if not on_device_mesh():
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import to_placements

    want = to_placements(resolve(tuple(x.shape), spec, x.device_mesh), x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def reduce_partial(x):
    """A DTensor's pending (``Partial``) sums reduced (to ``Replicate()`` on
    those mesh dims); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def placed_like(t, ref):
    """A plain tensor ``t`` that broadcasts over ``ref``'s trailing dims,
    as a DTensor sharded where ``ref`` is on those dims (each rank its own
    slice, no collective), when ``ref`` is a DTensor; else ``t``. A mask
    over a sharded dim then meets its operand shard by shard, where a
    replicated one would gather the operand."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    lead = ref.ndim - t.ndim
    placements = [Shard(p.dim - lead) if p.is_shard() and p.dim >= lead else Replicate()
                  for p in ref.placements]
    return distribute_tensor(t, ref.device_mesh, placements, src_data_rank=None)


def distribute(t, spec: Sequence, device_mesh):
    """A plain tensor as a DTensor on ``device_mesh`` at the resolved
    ``spec`` (each rank keeps its own slice; nothing is sent): a buffer
    the mesh program makes, such as the serving cache."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import to_placements

    placements = to_placements(resolve(tuple(t.shape), spec, device_mesh), device_mesh)
    return distribute_tensor(t, device_mesh, placements, src_data_rank=None)


def settle(g, placements):
    """A DTensor (a gradient) redistributed to ``placements``, its pending
    sums scattered first where the target is sharded and reduced after:
    the reductions then move a shard, not the whole tensor (DTensor would
    take the mesh dims in order). Anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(g, DTensor) or tuple(g.placements) == tuple(placements):
        return g
    first = [q if gp.is_partial() and q.is_shard() else gp
             for gp, q in zip(g.placements, placements)]
    if first != list(g.placements):
        g = g.redistribute(g.device_mesh, first)
    return g.redistribute(g.device_mesh, placements)
