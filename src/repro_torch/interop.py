"""Weights and training state carried across from the JAX package, as numpy.

Every function takes numpy arrays (or anything ``np.asarray`` accepts), never
JAX objects, so this module imports no JAX: the caller does the ``np.asarray``
on its side. Dict keys, tuple nesting and leaf order are kept, so a carried
tree packs into the same flat bytes (core/flatspace.py).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.runners import SimState

Tree = Any


def _tensor(x, device) -> torch.Tensor:
    # np.array copies: the result never aliases the caller's buffer
    return torch.from_numpy(np.array(x)).to(device)


def dense_from_numpy(tree: Tree, device="cpu") -> Tree:
    """The JAX dense tree ({"bottom": (layer, ...), "top": ...}), or any tree
    of arrays (an optimizer state, a replica stack) -> the port's."""
    return T.map(lambda x: _tensor(x, device), tree)


def tables_from_numpy(state: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """{"table", "acc"} -> the port's embedding state."""
    return {"table": _tensor(state["table"], device), "acc": _tensor(state["acc"], device)}


def sim_state_from_numpy(w_stack: Tree, opt_stack: Tree, emb_state: Dict[str, Any],
                         algo_state: Tree, step: int = 0, device="cpu") -> SimState:
    """The JAX ``SimState``'s fields -> a port ``SimState``. ``w_stack`` is the
    flat (R, n_rows, 128) buffer or the tree stack, as the engine has it;
    ``algo_state`` the EASGD PS plane (flat) or PS tree (pytree)."""
    return SimState(dense_from_numpy(w_stack, device), dense_from_numpy(opt_stack, device),
                    tables_from_numpy(emb_state, device), dense_from_numpy(algo_state, device),
                    int(step))


def tree_to_numpy(tree: Tree) -> Tree:
    """The reverse direction, for the round trip."""
    return T.map(lambda x: x.detach().cpu().numpy(), tree)
