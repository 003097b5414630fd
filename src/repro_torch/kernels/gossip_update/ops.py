"""Public wrappers of the gossip kernels over flat replica space.

``gossip_round_op`` is HogwildSim's landing: one launch covering every pair
that formed in a round, in place on the stack. ``gossip_pair_flat_op`` is
the threaded runner's shadow-thread primitive: one symmetric pair exchange
per launch, out of place. CUDA tensors go through the hand-written kernels,
CPU tensors through the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.gossip_update.gossip_update import gossip_pair_update, gossip_round_update
from repro_torch.kernels.gossip_update.ref import gossip_pair_ref, gossip_round_ref


def gossip_pair_flat_op(w_a: torch.Tensor, w_b: torch.Tensor,
                        alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric pair exchange on (n, 128) flat planes -> (new_a, new_b).
    Out of place: the threaded runner's trainer threads may still be reading
    these planes."""
    if not w_a.is_cuda:
        return gossip_pair_ref(w_a, w_b, alpha)
    out = gossip_pair_update(w_a, w_b, alpha)
    backend.count_launch(gossip_pair_flat_op)
    return out


gossip_pair_flat_op.launches = 0  # kernel launches since the last reset


def gossip_round_op(stack: torch.Tensor, snapshot: torch.Tensor, land: torch.Tensor,
                    self_pos: torch.Tensor, partner_pos: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """All pair landings of a round over a (R, n, 128) buffer, in place, one
    launch. ``snapshot`` must be a separate buffer (the compact launch
    gather), never the live stack. Rows not in ``land`` are bitwise
    unchanged. Returns ``stack``."""
    backend.require(land.dim() == 1 and land.shape[0] >= 1,
                    f"needs at least one participant, got shape {tuple(land.shape)}")
    if not stack.is_cuda:
        return gossip_round_ref(stack, snapshot, land, self_pos, partner_pos, alpha)
    gossip_round_update(stack, snapshot, land, self_pos, partner_pos, alpha)
    backend.count_launch(gossip_round_op)
    return stack


gossip_round_op.launches = 0
