"""Input structures for every (arch x input shape x mesh x mode), without
allocation (the twin of ``repro/launch/specs.py``).

Each function here returns a pair of matching trees, ``(structs, specs)``: the
structs are fake tensors made under a ``FakeTensorMode`` (shapes, dtypes and
strides, no storage), where the reference calls ``jax.eval_shape``; each
spec is ``sharding/rules.py``'s placement of that leaf on the mesh, where
the reference attaches a ``NamedSharding``. On a ``Mesh`` description the
structs stay fake tensors of the global shapes (the one-card program reads
no spec; the dry run reports them). On a ``DeviceMesh`` each struct is a
DTensor with the spec's placements over a ``meta`` local shard (``place``):
one rank's shard of the mesh program's arguments, without storage. Each
makes its tensors in ``fake``, or in the mode of the structs it is given, or
in a new mode: tensors of two modes cannot meet in one operation.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import spmd
from repro_torch.launch.mesh import is_device_mesh, mesh_shape
from repro_torch.models.layers import dtype_of
from repro_torch.sharding import rules

Pair = Tuple[Any, Any]
TOKEN_DTYPE = torch.int32  # the reference's token structs


def _fake(fake: Optional[FakeTensorMode], like=None) -> FakeTensorMode:
    """``fake``; else the mode of the structs ``like`` was made in; else a
    new one."""
    if fake is not None:
        return fake
    mode = getattr(T.leaves(like)[0], "fake_mode", None) if like is not None else None
    return mode if mode is not None else FakeTensorMode()


def local_shape(shape, placements, device_mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of global ``shape``: each dim
    split evenly over the mesh dims it is sharded on."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = device_mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways "
                                 f"({placements})")
            out[p.dim] //= n
    return tuple(out)


def place(structs, specs, device_mesh):
    """Each tensor of ``structs`` as a DTensor on ``device_mesh`` with its
    spec's placements: a fake or ``meta`` tensor over a ``meta`` local shard
    of the same dtype (nothing allocated), a real one over its own shard
    (``distribute_tensor`` without a broadcast: every rank holds the same
    full tensor). Other leaves stay as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, t):
        if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
            return t
        placements = rules.to_placements(on_mesh(_at(specs, path), device_mesh), device_mesh)
        if t.is_meta or getattr(t, "fake_mode", None) is not None:
            local = torch.empty(local_shape(t.shape, placements, device_mesh), dtype=t.dtype,
                                device="meta")
            return DTensor.from_local(local, device_mesh, placements, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, device_mesh, placements, src_data_rank=None)

    return rules.tree_map_with_path(one, structs)


def on_mesh(spec, device_mesh) -> tuple:
    """``spec`` with the axes ``device_mesh`` lacks left out: shadow mode's
    replica axis "pod" on a single-pod mesh, where every rank holds every
    replica and trains each in turn."""
    names = set(device_mesh.mesh_dim_names)

    def keep(ax):
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a in names)
            return ax if len(ax) > 1 else (ax[0] if ax else None)
        return ax if ax in names else None

    return tuple(keep(ax) for ax in spec)


def _at(tree, path):
    for p in path:
        tree = getattr(tree, p.name) if isinstance(p, rules.Attr) else tree[p]
    return tree


def _placed(structs, specs, mesh) -> Pair:
    """``(structs, specs)``, the structs placed on ``mesh`` when it is a
    ``DeviceMesh``."""
    return (place(structs, specs, mesh) if is_device_mesh(mesh) else structs), specs


def batch_axes(mesh, mode: str) -> Tuple[str, ...]:
    if mode == "shadow":
        return ("data",)  # the replica dim carries the pod axis
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _global(tree, fake: Optional[FakeTensorMode]):
    """A tree of fake structs with each DTensor as a fake tensor of its
    global shape (the one-process structures ``init`` functions read)."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in T.leaves(tree)):
        return tree
    with _fake(fake):
        return T.map(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype)
                     if isinstance(t, DTensor) else t, tree)


def _stack(tree, n: int):
    """``n`` replicas of each leaf, (n, *shape), as ``spmd.stack_replicas``
    lays them out."""
    return T.map(lambda x: torch.empty((n, *x.shape), dtype=x.dtype), tree)


def param_structs(cfg: ArchConfig, mesh, *, mode: str = "syncdp", fsdp: bool = True,
                  n_replicas: int = 2, fake: Optional[FakeTensorMode] = None) -> Pair:
    """The parameters (``spmd.init_params``), with a leading replica dim of
    ``n_replicas`` on the pod axis in shadow mode."""
    with _fake(fake):
        structs = spmd.init_params(cfg, torch.Generator(), device="cpu")
        if mode == "shadow":
            structs = _stack(structs, n_replicas)
    replica_axis = "pod" if mode == "shadow" else None
    return _placed(structs, rules.build_param_specs(
        structs, mesh, fsdp_axis="data" if fsdp else None, replica_axis=replica_axis), mesh)


def opt_structs(opt, params_structs, mesh, *, replica_axis=None, fsdp: bool = True,
                fake: Optional[FakeTensorMode] = None) -> Pair:
    """The optimizer state of ``params_structs``, sharded like them. With a
    replica axis, one replica's state stacked over the replicas (Adam's
    step count too, as the port's shadow step slices every leaf)."""
    params_structs = _global(params_structs, fake)
    with _fake(fake, params_structs):
        if replica_axis is None:
            structs = opt.init(params_structs)
        else:
            n = T.leaves(params_structs)[0].shape[0]
            structs = _stack(opt.init(T.map(lambda x: x[0], params_structs)), n)
    return _placed(structs, rules.build_param_specs(
        structs, mesh, fsdp_axis="data" if fsdp else None, replica_axis=replica_axis), mesh)


def sync_state_structs(sync_cfg, params_structs, mesh, *, fsdp: bool = True,
                       fake: Optional[FakeTensorMode] = None) -> Pair:
    """A registered sync algorithm's state (the sync-PS copy, momentum
    buffers, a counter, or None) from the single-replica parameters,
    sharded like optimizer state."""
    from repro_torch.core import algorithms

    params_structs = _global(params_structs, fake)
    with _fake(fake, params_structs):
        structs = algorithms.get(sync_cfg.algo).init_state(params_structs, sync_cfg)
    if structs is None:
        return None, None
    return _placed(structs, rules.build_param_specs(
        structs, mesh, fsdp_axis="data" if fsdp else None), mesh)


def train_batch_structs(cfg: ArchConfig, shape: InputShape, mesh, *, mode: str = "syncdp",
                        n_replicas: int = 2, fake: Optional[FakeTensorMode] = None) -> Pair:
    """The token batch (int32), and the vlm family's ``prefix_embeds`` (its
    image tokens come out of the sequence) or the audio family's
    ``frames``, in the config's dtype; (R, B / R, ...) in shadow mode."""
    bx = batch_axes(mesh, mode)
    ax = bx if len(bx) > 1 else bx[0]
    B, S = shape.global_batch, shape.seq_len
    dtype = dtype_of(cfg.dtype)
    lead, lead_spec = ((n_replicas, B // n_replicas), ("pod", ax)) if mode == "shadow" \
        else ((B,), (ax,))
    structs, specs = {}, {}
    with _fake(fake):
        def add(name, trailing, dt):
            structs[name] = torch.empty((*lead, *trailing), dtype=dt)
            specs[name] = (*lead_spec,) + (None,) * len(trailing)

        if cfg.family == "vlm":
            n_img = cfg.frontend.n_tokens
            add("tokens", (S - n_img,), TOKEN_DTYPE)
            add("prefix_embeds", (n_img, cfg.d_model), dtype)
        elif cfg.family == "audio":
            add("tokens", (S,), TOKEN_DTYPE)
            add("frames", (cfg.encoder.n_ctx, cfg.d_model), dtype)
        else:
            add("tokens", (S,), TOKEN_DTYPE)
    return _placed(structs, specs, mesh)


def _cache_sharding(path, leaf, mesh_shape: Dict[str, int]) -> rules.Spec:
    names = rules._path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    data_n, model_n = mesh_shape.get("data", 1), mesh_shape.get("model", 1)
    spec = [None] * nd
    data_used = nd >= 2 and shape[1] % data_n == 0 and shape[1] >= data_n
    if data_used:
        spec[1] = "data"
    if name in ("k", "v") and nd == 5:  # (L, B, S, kv, hd)
        if not data_used and shape[2] % data_n == 0:
            spec[2] = "data"
        if shape[3] % model_n == 0:
            spec[3] = "model"
        elif shape[4] % model_n == 0:
            spec[4] = "model"
    elif name == "ssm" and nd == 5:  # (L, B, H, p, n)
        if shape[2] % model_n == 0:
            spec[2] = "model"
    elif name == "conv" and nd == 4:  # (L, B, K, C)
        if shape[3] % model_n == 0:
            spec[3] = "model"
    return tuple(spec)


def cache_structs(cfg: ArchConfig, batch: int, s_max: int, mesh,
                  fake: Optional[FakeTensorMode] = None) -> Pair:
    """The serving cache (``spmd.init_cache``) of ``s_max`` positions."""
    with _fake(fake):
        structs = spmd.init_cache(cfg, batch, s_max, device="cpu")
    return _placed(structs, rules.tree_map_with_path(
        lambda path, leaf: _cache_sharding(path, leaf, mesh_shape(mesh)), structs), mesh)


def decode_batch_structs(cfg: ArchConfig, shape: InputShape, mesh,
                         fake: Optional[FakeTensorMode] = None) -> Pair:
    """One decode step's token (B,) and position. The port's decode step
    takes the position as a host int; it is the cache's last one,
    ``seq_len - 1``, where the step reads every cached position (the
    reference's fixed-shape mask reads all ``S_max`` at any position)."""
    B = shape.global_batch
    data_n = mesh_shape(mesh).get("data", 1)
    with _fake(fake):
        token = torch.empty((B,), dtype=TOKEN_DTYPE)
    tok_spec = ("data",) if B % data_n == 0 and B >= data_n else (None,)
    specs = {"token": tok_spec, "pos": ()}
    return _placed({"token": token, "pos": shape.seq_len - 1}, specs, mesh)
