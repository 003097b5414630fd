"""Weights and training state carried across from the JAX package, as numpy.

Every function takes numpy arrays (or anything ``np.asarray`` accepts), never
JAX objects, so this module imports no JAX: the caller does the ``np.asarray``
on its side. Dict keys, tuple nesting and leaf order are kept, so a carried
tree packs into the same flat bytes (core/flatspace.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.runners import SimState
from repro_torch.core.sync import BMUFState
from repro_torch.embeddings import shards

Tree = Any


def _tensor(x, device) -> torch.Tensor:
    # np.array copies: the result never aliases the caller's buffer
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # numpy's extension type: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def dense_from_numpy(tree: Tree, device="cpu") -> Tree:
    """The JAX dense tree ({"bottom": (layer, ...), "top": ...}), or any tree
    of arrays (an optimizer state, a replica stack) -> the port's."""
    return T.map(lambda x: _tensor(x, device), tree)


def tables_from_numpy(state: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """{"table", "acc"} -> the port's embedding state."""
    return {"table": _tensor(state["table"], device), "acc": _tensor(state["acc"], device)}


def algo_state_from_numpy(algo_name: str, state: Any, device="cpu") -> Any:
    """A JAX algorithm state, its arrays as numpy -> the port's. EASGD: the PS
    plane (flat) or tree (pytree); BMUF: anything with ``w_global`` and
    ``velocity`` (the reference's ``BMUFState``, or a dict of the two) ->
    ``BMUFState``; Gossip: the round counter -> a host int; MA: None. Any
    other algorithm's state is carried as a tree of arrays (None stays None)."""
    if algo_name == "gossip":
        return int(np.asarray(state))
    if algo_name == "bmuf":
        get = state.get if isinstance(state, dict) else lambda k: getattr(state, k)
        return BMUFState(w_global=dense_from_numpy(get("w_global"), device),
                         velocity=dense_from_numpy(get("velocity"), device))
    if state is None:
        return None
    return dense_from_numpy(state, device)


def sim_state_from_numpy(w_stack: Tree, opt_stack: Tree, emb_state: Dict[str, Any],
                         algo_state: Any, step: int = 0, device="cpu",
                         algo: str = "easgd") -> SimState:
    """The JAX ``SimState``'s fields -> a port ``SimState``. ``w_stack`` is the
    flat (R, n_rows, 128) buffer or the tree stack, as the engine has it;
    ``algo_state`` that of the algorithm ``algo`` (``algo_state_from_numpy``)."""
    return SimState(dense_from_numpy(w_stack, device), dense_from_numpy(opt_stack, device),
                    tables_from_numpy(emb_state, device),
                    algo_state_from_numpy(algo, algo_state, device), int(step))


def shard_states_from_numpy(plan: shards.ShardPlan, packed_state: Dict[str, Any],
                            device="cpu") -> List[Dict[str, torch.Tensor]]:
    """A packed {"table", "acc"} state -> the port's per-shard states, split
    by ``plan`` as ``EmbeddingShards.init`` splits the tables it draws."""
    return shards.shard_states(plan, tables_from_numpy(packed_state, device))


def lm_params_from_numpy(tree: Tree, device="cpu") -> Tree:
    """The JAX ``spmd.init_params`` tree of an LM (its leaves as numpy, f32
    or bfloat16, side by side in one tree where the model keeps some leaves
    f32: mamba2's ``A_log``, ``dt_bias``, ``D``, the MoE router) -> the
    port's parameters, each leaf in its own dtype: the same keys and the
    same stacked ``unit`` tuple (``models/transformer.py``), llava's
    ``projector`` among them; for whisper the stacked ``enc`` and ``dec``
    trees (``models/whisper.py``)."""
    return T.map(lambda x: _tensor(x, device), tree)


def lm_train_state_from_numpy(stack: Tree, opt_stack: Tree, algo: str, algo_state: Any,
                              device="cpu") -> Tuple[Tree, Tree, Any]:
    """The JAX LM trainer's state (``launch/train.py::run_lm``), its arrays as
    numpy -> the port's (``core/spmd.py``): the replica stack of parameters
    (leaves (R, ...)), the stacked optimizer state (Adam's ``m``, ``v`` and
    its (R,) step count ``t``; ``()`` for SGD) and the state of the sync
    algorithm ``algo`` (``algo_state_from_numpy``)."""
    return (lm_params_from_numpy(stack, device), lm_params_from_numpy(opt_stack, device),
            algo_state_from_numpy(algo, algo_state, device))


def tree_to_numpy(tree: Tree) -> Tree:
    """The reverse direction, for the round trip."""
    return T.map(lambda x: x.detach().cpu().numpy(), tree)
