"""The LM trainer under ShadowSync, the twin of ``repro/core/spmd.py``.

Shadow mode (``"shadow"``): parameters and optimizer state carry a leading
replica dim R, and each replica trains on its own slice of the batch. No
operation of replica r's step reads another replica's slice, so the step
holds no cross-replica traffic; the per-replica losses come back
unreduced. ``sync_step`` is a separate program that owns all cross-replica
traffic (``algorithms.SyncAlgorithm.make_sync_step``), run by the caller at
its own cadence. Baseline mode (``"syncdp"``): one model, one step.

The reference ``vmap``s one replica's step over R and returns new trees,
which at full width would hold the stack and its optimizer state twice at
the update. The port loops over the replicas instead: each replica's
gradients are taken with respect to detached views of its slice (only one
replica's gradients are alive at a time) and the update is written back
into the stacks leaf by leaf (``optim.update_in_place``), bitwise the
functional update. So a step updates ``params`` and ``opt_state`` in place
and returns them.

Every family trains and serves here: the dense, moe, ssm, hybrid and vlm
ones through ``models/transformer.py``, the audio one (whisper) through
``models/whisper.py``. Trees may mix dtypes (mamba2's f32 ``A_log``,
``dt_bias`` and ``D`` and the MoE router beside bf16 weights), which every
update and sync keeps leaf by leaf.

On a device mesh (trees of DTensors placed by ``launch/specs.py``, under
``sharding.ctx.activation_mesh``) the same steps are the reference's mesh
program. Shadow mode: the replica dim is ``Shard(0)`` on "pod", and each
rank trains only the replicas it holds, each as a tree of DTensors on the
("data", "model") sub-mesh over views of its local shards
(``_local_replicas``): indexing the pod-sharded stack would all-gather it
across pods, the very traffic ShadowSync keeps out of the step. So the
step's only collectives run within a pod, and its losses come back
unreduced, (R,) on "pod". Syncdp: the batch is sharded over ("pod",
"data") and the gradients' ``Partial`` placements are reduced over both
where the update meets its parameters (an all-reduce, or a reduce-scatter
for an FSDP-sharded leaf). The sync step's pytree ``land`` runs on the
pod-sharded stacks, so its means and pulls cross the pods. Microbatches
split each rank's local batch, so no microbatch moves data.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import optim, tracing
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import algorithms
from repro_torch.core import sync as S
from repro_torch.models import transformer, whisper
from repro_torch.models.layers import mm
from repro_torch.sharding.ctx import settle

Tree = Any


def on_mesh(tree: Tree) -> bool:
    """Whether ``tree`` holds DTensors (the mesh program's arguments)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in T.leaves(tree))


def _split_local(x, k: int, j: int):
    """Microbatch ``j`` of ``k`` of a DTensor batch leaf: the ``j``-th of ``k``
    equal parts of each rank's local rows, placed as ``x`` is (no data
    moves)."""
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    part = local.reshape(k, local.shape[0] // k, *local.shape[1:])[j]
    shape = (x.shape[0] // k, *x.shape[1:])
    return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False, shape=shape,
                              stride=part.stride())


def _local_replicas(stack: Tree, replica_axis: str = "pod"):
    """The replicas this rank holds of a stack whose leaves carry a leading
    replica dim, ``Shard(0)`` on ``replica_axis`` (or held whole where the
    mesh has no such axis): one tree a local replica, each leaf a DTensor
    on the other mesh dims' sub-mesh over a view of the local shard (an
    update written into it lands in the stack). Returns (replicas, the
    stack's mesh, the replica axis's mesh dim or None)."""
    from torch.distributed.tensor import DTensor, Shard

    leaves = T.leaves(stack)
    dm = leaves[0].device_mesh
    names = tuple(dm.mesh_dim_names)
    i = names.index(replica_axis) if replica_axis in names else None
    sub = dm if i is None else dm[tuple(n for n in names if n != replica_axis)]
    n_local = leaves[0].to_local().shape[0]

    def view(x, r):
        placements = list(x.placements)
        if x.device_mesh != dm or (i is not None and placements[i] != Shard(0)):
            raise ValueError(f"a replica stack's leaf is {placements} on {x.device_mesh}; "
                             f"expected Shard(0) on {replica_axis!r}")
        if i is not None:
            del placements[i]
        if any(p.is_shard(0) for p in placements):
            raise ValueError(f"the replica dim is sharded off {replica_axis!r}: {x.placements}")
        placements = [Shard(p.dim - 1) if p.is_shard() else p for p in placements]
        return DTensor.from_local(x.to_local()[r], sub, placements, run_check=False,
                                  shape=x.shape[1:], stride=x.stride()[1:])

    with torch.no_grad():
        return [T.map(lambda x: view(x, r), stack) for r in range(n_local)], dm, i


def _replicated(loss):
    """A DTensor loss reduced to ``Replicate()`` on its mesh (within the
    mesh it lies on; a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(loss, DTensor) or all(p.is_replicate() for p in loss.placements):
        return loss
    return loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)


def _loss_fn(cfg: ArchConfig, remat_policy: str = "full") -> Callable:
    """The training loss: whisper's with no unit remat (as the reference's),
    every other family's with its units rematerialised under
    ``remat_policy`` ("full" or "save_comm")."""
    transformer.check_remat_policy(remat_policy)
    if cfg.family == "audio":
        return lambda p, b: whisper.loss_fn(p, cfg, b)
    return lambda p, b: transformer.loss_fn(p, cfg, b, remat=True, remat_policy=remat_policy)


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None, dtype=None) -> Tree:
    if cfg.family == "audio":
        return whisper.init_params(cfg, gen, device=device, dtype=dtype)
    return transformer.init_params(cfg, gen, device=device, dtype=dtype)


def stack_replicas(params: Tree, n: int) -> Tree:
    """R copies of each leaf, (n, *shape): real copies, since the train step
    writes into each replica's slice (the reference's broadcast view would
    alias them)."""
    return T.map(lambda x: x.unsqueeze(0).repeat(n, *([1] * x.dim())), params)


def _accum_grads(loss_fn: Callable, params: Tree, batch: Tree, n_microbatches: int,
                 grad_dtype=torch.float32) -> Tuple[Tree, torch.Tensor]:
    """(grads, loss) of ``loss_fn`` at ``params`` (leaves that require
    grad). With K > 1 microbatches (the batch dim split K ways, in order),
    the gradients are summed in ``grad_dtype`` and divided by K, as the
    losses are; with K = 1 the gradients are the raw ones, uncast. A leaf
    the loss does not read (llava's projector, trained on tokens alone)
    gets zeros, as under ``jax.grad``."""
    leaves = T.leaves(params)

    def grad(loss):
        return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    if n_microbatches <= 1:
        loss = _replicated(loss_fn(params, batch))
        grads = grad(loss)
        return T.unflatten(params, list(grads)), loss.detach()
    k = n_microbatches
    if on_mesh(batch):  # each rank's local rows, split k ways; sums kept Partial
        micro = [T.map(lambda x: _split_local(x, k, j), batch) for j in range(k)]
        acc, acc_l = None, 0.0
    else:
        mb = T.map(lambda x: x.reshape(k, x.shape[0] // k, *x.shape[1:]), batch)
        micro = [S.tree_slice(mb, j) for j in range(k)]
        acc = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device) for p in leaves]
        acc_l = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for j in range(k):
        loss = _replicated(loss_fn(params, micro[j]))
        grads = grad(loss)
        if acc is None:  # on a mesh: the first microbatch's sums, left pending
            acc = [g.to(grad_dtype) for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.to(grad_dtype))
        acc_l = acc_l + loss.detach()
    return T.unflatten(params, [a / float(k) for a in acc]), acc_l / float(k)


def make_train_step(
    cfg: ArchConfig,
    opt: optim.Optimizer,
    mode: str,
    n_microbatches: int = 1,
    grad_dtype: str = "float32",
    remat_policy: str = "full",
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss), updating ``params`` and ``opt_state`` in place. ``"shadow"``:
    leaves carry a leading replica dim and ``loss`` is (R,); ``"syncdp"``:
    one model, a scalar ``loss``. The loss runs the training form with its
    units rematerialised under ``remat_policy``, as the reference's does."""
    if mode not in ("shadow", "syncdp"):
        raise ValueError(f"unknown mode {mode!r}; expected 'shadow' or 'syncdp'")
    loss_fn = _loss_fn(cfg, remat_policy)
    gdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[grad_dtype]

    def one(params, opt_state, batch) -> torch.Tensor:
        live = T.map(lambda a: a.detach().requires_grad_(), params)
        with tracing.span("train.fwd_bwd"):
            grads, loss = _accum_grads(loss_fn, live, batch, n_microbatches, gdt)
        del live
        # on a mesh each gradient takes its parameter's placements: an
        # all-reduce where it is replicated, FSDP's reduce-scatter where sharded
        grads = [settle(g, p.placements) if isinstance(g, DTensor) else g
                 for g, p in zip(T.leaves(grads), T.leaves(params))]
        with torch.no_grad(), tracing.span("train.optim"):
            optim.update_in_place(opt, params, opt_state, grads)
        return loss

    if mode == "shadow":
        def train_step(params, opt_state, batch):
            with tracing.span("train.step"):
                if on_mesh(params):
                    return params, opt_state, _shadow_on_mesh(one, params, opt_state, batch)
                R = T.leaves(params)[0].shape[0]
                losses = [one(S.tree_slice(params, r), S.tree_slice(opt_state, r),
                              S.tree_slice(batch, r)) for r in range(R)]
                return params, opt_state, torch.stack(losses)

        return train_step

    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            return params, opt_state, one(params, opt_state, batch)

    return train_step


def _shadow_on_mesh(one: Callable, params: Tree, opt_state: Tree, batch: Tree):
    """The shadow step on a mesh: ``one`` on each local replica's views
    (``_local_replicas``), so nothing crosses the pods. Returns the (R,)
    losses, ``Shard(0)`` on "pod" (replicated on a mesh without one), each
    reduced within its own pod only."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    reps, dm, i = _local_replicas(params)
    states = _local_replicas(opt_state)[0] if T.leaves(opt_state) else [opt_state] * len(reps)
    batches = _local_replicas(batch)[0]
    losses = [_replicated(one(p, st, b)).to_local() for p, st, b in zip(reps, states, batches)]
    placements = [Replicate()] * dm.ndim
    if i is not None:
        placements[i] = Shard(0)
    R = T.leaves(params)[0].shape[0]
    return DTensor.from_local(torch.stack(losses), dm, placements, run_check=False, shape=(R,),
                              stride=(1,))


def make_sync_step(cfg: ArchConfig, sync_cfg: S.SyncConfig) -> Callable:
    """The background program; it owns all cross-replica communication.
    ``sync_step(params_stack, algo_state) -> (params_stack, algo_state)``
    for every registered algorithm, ``algo_state`` from
    ``algorithms.get(name).init_state(params, sync_cfg)``; a call is the
    span ``train.sync``."""
    step = algorithms.get(sync_cfg.algo).make_sync_step(sync_cfg)

    def sync_step(params_stack, algo_state):
        with tracing.span("train.sync"):
            return step(params_stack, algo_state)

    return sync_step


def make_prefill_step(cfg: ArchConfig, s_max: int) -> Callable:
    """prefill(params, batch) -> (last logits, cache), without gradients
    (the prefill form: K9 on the card). batch: {"tokens": (B, S)[,
    "prefix_embeds": (B, P, d)]}, or for audio {"tokens", "frames": (B,
    n_ctx, d)}.

    The audio prefill is the reference's, literally
    (``repro/core/spmd.py:128-135``): its self-attention cache is
    ``init_cache``'s zeros (the prompt's own K/V are never cached), its
    cross cache the encoder's K/V, and its logits ``hidden[:, -1] @
    table.T`` over the padded vocabulary with nothing masked."""
    if cfg.family == "audio":
        @torch.no_grad()
        def prefill(params, batch):
            enc_out = whisper.encode(params, cfg, batch["frames"])
            hidden = whisper.decode_full(params, cfg, batch["tokens"], enc_out,
                                         return_hidden=True)
            logits = mm(hidden[:, -1, :], params["embed"]["table"].T)
            cache = whisper.init_cache(cfg, batch["tokens"].shape[0], s_max,
                                       device=hidden.device)
            return logits, {"self": cache["self"],
                            "cross": whisper.build_cross_cache(params, cfg, enc_out)}

        return prefill

    @torch.no_grad()
    def prefill(params, batch):
        return transformer.prefill(params, cfg, batch["tokens"], s_max,
                                   prefix_embeds=batch.get("prefix_embeds"))

    return prefill


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode(params, cache, token (B,), pos) -> (logits (B, vocab_size),
    cache), the cache written in place, without gradients."""
    model = whisper if cfg.family == "audio" else transformer

    @torch.no_grad()
    def decode(params, cache, token, pos):
        return model.decode_step(params, cfg, cache, token, int(pos))

    return decode


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device=None) -> Tree:
    model = whisper if cfg.family == "audio" else transformer
    return model.init_cache(cfg, batch, s_max, dtype=dtype, device=device)
