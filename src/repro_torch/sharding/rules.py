"""Parameter, cache and batch partition rules as plain data (the twin of
``repro/sharding/rules.py``).

Baseline layout ("megatron + fsdp"): the tensor-parallel dim of every matmul
weight shards over ``model``; the other dim shards over ``fsdp_axis``
(usually ``data``) for the giant archs. Experts shard over ``model``. Specs
are right-aligned so stacked layer leaves (the leading ``repeats`` dim)
inherit the trailing rule; a tree with a leading replica dim puts the
replica axis (``pod``) first.

A spec is a tuple with one entry a dim, each an axis name, a tuple of
axis names or ``None``, as ``jax.sharding.PartitionSpec`` is; the specs are
held equal to the reference's (``tests/test_torch_sharding.py``). The
one-card program reads none of them. On a ``DeviceMesh`` a spec becomes
DTensor placements (``to_placements``, ``build_param_placements``), where
the reference attaches a ``NamedSharding``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

Spec = Tuple[Optional[str], ...]

# name -> spec for the *trailing* dims of the weight (tp = the model axis's
# slot, fsdp = the fsdp axis's slot)
_RULES = {
    # attention / generic matmuls: (d_in, d_out_tp)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # embeddings / unembedding: vocab over model
    "table": ("tp", None),
    "w": ("fsdp", "tp"),  # lm_head / projector
    # mamba2
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "norm_scale": ("tp",),
    # moe router
    "router": (None, None),
    # small per-head vectors: replicate
    "dt_bias": (None,),
    "A_log": (None,),
    "D": (None,),
    # norms / biases: replicate
    "scale": (None,),
    "bias": (None,),
    "b": (None,),
}

# MoE expert weights are 3D (E, d, f): override the 2D rule
_MOE_RULES = {
    "w_gate": ("tp", "fsdp", None),
    "w_up": ("tp", "fsdp", None),
    "w_down": ("tp", None, "fsdp"),
}


@dataclasses.dataclass(frozen=True)
class Attr:
    """A dataclass field on a path; ``_path_names`` skips it, as the
    reference's skips ``GetAttrKey``."""

    name: str


def _resolve(slots, model_axis, fsdp_axis) -> Spec:
    out = []
    for s in slots:
        if s == "tp":
            out.append(model_axis)
        elif s == "fsdp":
            out.append(fsdp_axis)
        else:
            out.append(None)
    return tuple(out)


def _path_names(path) -> list:
    """A path's dict keys and sequence indices as strings (``Attr`` entries
    dropped)."""
    return [str(p) for p in path if not isinstance(p, Attr)]


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts (keys in sorted order, as
    ``tree.py`` visits them), tuples, lists and dataclasses; a path is a
    tuple of dict keys, sequence indices and ``Attr`` fields. ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                                        path + (Attr(f.name),))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, t, path + (i,)) for i, t in enumerate(tree))
    return fn(path, tree)


def _divisible(dim, shape, spec, mesh_shape) -> Spec:
    """Drop sharding on axes the dim does not divide into (GSPMD pads
    otherwise)."""
    out = []
    for size, ax in zip(tuple(shape)[-len(spec):] if spec else (), spec):
        if ax is None:
            out.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh_shape[a]
        out.append(ax if (size >= n and size % n == 0) else None)
    return tuple(out)


def param_spec(path, leaf, *, model_axis="model", fsdp_axis=None, mesh_shape=None,
               replica_axis=None) -> Spec:
    """The spec of one parameter (or optimizer-state) leaf at ``path``."""
    names = _path_names(path)
    name = names[-1] if names else ""
    ndim = len(leaf.shape)
    # MoE expert weights are (E, d, f) a layer, so ndim >= 4 once stacked
    # over the unit's repeats (the only way these trees are built)
    in_moe = "ffn" in names and ndim >= 4 and name in _MOE_RULES
    slots = _MOE_RULES[name] if in_moe else _RULES.get(name, None)
    base = (None,) * ndim if slots is None else _resolve(slots, model_axis, fsdp_axis)
    # right-align: leading stacked dims (unit repeats) replicate...
    lead = ndim - len(base)
    spec = (None,) * lead + base
    if mesh_shape is not None:
        spec = (None,) * lead + _divisible(None, leaf.shape, base, mesh_shape)
    # ...unless this tree carries a leading replica dim
    if replica_axis is not None and ndim >= 1:
        spec = (replica_axis,) + spec[1:]
    return spec


def build_param_specs(params: Any, mesh, *, model_axis="model", fsdp_axis=None,
                      replica_axis=None) -> Any:
    """A tree of specs matching ``params``; ``mesh`` a ``launch.mesh.Mesh``
    or a ``DeviceMesh``."""
    from repro_torch.launch.mesh import mesh_shape

    shape = mesh_shape(mesh)
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, model_axis=model_axis, fsdp_axis=fsdp_axis,
                                      mesh_shape=shape, replica_axis=replica_axis),
        params)


def to_placements(spec, device_mesh) -> tuple:
    """One DTensor placement a dim of ``device_mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` of ``spec`` is sharded over (an axis
    tuple such as ``("pod", "data")`` shards it on each, major to minor, in
    mesh order as a ``PartitionSpec`` does), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        idx = [names.index(a) for a in (ax if isinstance(ax, tuple) else (ax,)
                                        if ax is not None else ())]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"spec {spec} on mesh {names}: an axis twice or out of mesh order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def build_param_placements(params: Any, device_mesh, *, model_axis="model", fsdp_axis=None,
                           replica_axis=None) -> Any:
    """``build_param_specs`` on a ``DeviceMesh``: a tree of placements
    matching ``params`` (the reference's ``NamedSharding`` tree)."""
    from repro_torch.launch.mesh import mesh_shape

    shape = mesh_shape(device_mesh)
    return tree_map_with_path(
        lambda path, leaf: to_placements(param_spec(
            path, leaf, model_axis=model_axis, fsdp_axis=fsdp_axis, mesh_shape=shape,
            replica_axis=replica_axis), device_mesh), params)


def kv_cache_spec(leaf_shape, mesh_shape: Dict[str, int], *, batch_axis="data",
                  model_axis="model") -> Spec:
    """Serving-cache sharding. Attention KV leaves are (repeats, B, S, kv,
    hd); mamba ssm state (repeats, B, H, p, n); conv state (repeats, B, K,
    C). Shard batch over ``data`` when divisible, else the length dim;
    kv-heads (or head_dim for MQA) over ``model`` when divisible."""
    nd = len(leaf_shape)
    data_n, model_n = mesh_shape[batch_axis], mesh_shape[model_axis]
    spec = [None] * nd
    b = leaf_shape[1] if nd >= 2 else 1
    data_used = nd >= 2 and b % data_n == 0 and b >= data_n
    if data_used:
        spec[1] = batch_axis
    if nd == 5:
        if not data_used and leaf_shape[2] % data_n == 0:
            spec[2] = batch_axis
        if leaf_shape[3] % model_n == 0:
            spec[3] = model_axis
        elif leaf_shape[4] % model_n == 0:
            spec[4] = model_axis
    elif nd == 4:
        if leaf_shape[3] % model_n == 0:
            spec[3] = model_axis
    return tuple(spec)


def batch_spec(kind: str, *, replica_axis=None, batch_axes=("data",)) -> Spec:
    """Token batches: the batch dim over the data axes (plus pod in baseline
    mode); with a replica axis, (replica, batch, seq)."""
    ax = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
    if replica_axis is not None:
        return (replica_axis, ax, None)
    return (ax, None)
