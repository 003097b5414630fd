"""Public wrappers of the EASGD kernels over flat replica space.

``easgd_round_op``: a sync is one launch over the persistent (R, n, 128)
buffer (core/flatspace.py), in place on the stack and the PS plane.
``easgd_pair_flat_op``: one PS<->replica exchange on two (n, 128) planes,
the threaded runner's path, out of place. ``easgd_pair_op`` keeps the
reference's arbitrary-tree API and packs through FlatSpace per call.
CUDA tensors go through the hand-written kernels, CPU tensors through the
plain versions.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.flatspace import FlatSpace
from repro_torch.kernels import backend
from repro_torch.kernels.easgd_update.easgd_update import easgd_round_update, easgd_update
from repro_torch.kernels.easgd_update.ref import easgd_round_ref, easgd_update_ref

BLOCK = 256


def easgd_round_op(stack: torch.Tensor, w_ps: torch.Tensor, snapshot: torch.Tensor,
                   fired: torch.Tensor, alpha: float):
    """Masked sequential round. ``fired``: (F,) int32 replica ids in exchange
    order; ``snapshot``: (F, n, 128) launch copies of exactly the fired
    replicas (positional), never a view of the live stack. Updates ``stack``
    and ``w_ps`` in place; rows not in ``fired`` are untouched. Returns them."""
    if not stack.is_cuda:
        return easgd_round_ref(stack, w_ps, snapshot, fired, alpha)
    easgd_round_update(stack, w_ps, snapshot, fired, alpha)
    backend.count_launch(easgd_round_op)
    return stack, w_ps


easgd_round_op.launches = 0  # kernel launches since the last reset


def easgd_pair_flat_op(w_ps: torch.Tensor, w_i: torch.Tensor,
                       alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PS<->replica exchange on (n, 128) flat planes -> (new_ps, new_wi).
    Out of place, as the reference's is not donated: the threaded runner's
    trainer threads may still be reading these planes."""
    if not w_ps.is_cuda:
        return easgd_update_ref(w_ps, w_i, alpha)
    out = easgd_update(w_ps, w_i, alpha)
    backend.count_launch(easgd_pair_flat_op)
    return out


easgd_pair_flat_op.launches = 0  # kernel launches since the last reset


def easgd_pair_op(w_ps: Any, w_i: Any, alpha: float) -> Tuple[Any, Any]:
    """The Algorithm-2 exchange over arbitrary trees (packs per call)."""
    space = FlatSpace.from_tree(w_ps, block=BLOCK)
    new_ps, new_wi = easgd_pair_flat_op(space.pack(w_ps), space.pack(w_i), alpha)
    return space.unpack(new_ps), space.unpack(new_wi)
