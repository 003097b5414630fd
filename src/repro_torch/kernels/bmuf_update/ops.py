"""Public wrappers of the BMUF landing kernel over flat replica space: one
launch per background landing (the launch-time replica mean comes from
``ma_update.ops.replica_mean_op``). ``bmuf_sync_rows_op`` is the
elastic-membership form over the live replica ids. Both are in place on the
stack, ``w_global`` and ``velocity`` (the reference donates all three).
CUDA tensors go through the hand-written kernel, CPU tensors through the
plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.bmuf_update.bmuf_update import bmuf_rows
from repro_torch.kernels.bmuf_update.ref import bmuf_update_ref, bmuf_update_rows_ref

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bmuf_sync_op(stack: torch.Tensor, mean: torch.Tensor, w_global: torch.Tensor,
                 velocity: torch.Tensor, alpha: float, *, eta: float = 1.0,
                 block_momentum: float = 0.0, nesterov: bool = False,
                 scale: float = 1.0) -> Planes:
    """The Algorithm-4 landing on every replica. Returns (stack, w_global,
    velocity), updated in place."""
    if not stack.is_cuda:
        return bmuf_update_ref(stack, mean, w_global, velocity, alpha, eta=eta,
                               block_momentum=block_momentum, nesterov=nesterov, scale=scale)
    rows = backend.index_tensor(range(stack.shape[0]), stack.device)
    bmuf_rows(stack, mean, w_global, velocity, rows, alpha, eta * scale, block_momentum, nesterov)
    backend.count_launch(bmuf_sync_op)
    return stack, w_global, velocity


bmuf_sync_op.launches = 0  # kernel launches since the last reset


def bmuf_sync_rows_op(stack: torch.Tensor, mean: torch.Tensor, w_global: torch.Tensor,
                      velocity: torch.Tensor, rows: torch.Tensor, alpha: float, *,
                      eta: float = 1.0, block_momentum: float = 0.0, nesterov: bool = False,
                      scale: float = 1.0) -> Planes:
    """The landing restricted to the LIVE rows (``rows``: (A,) int32, A >= 1):
    dead rows are never read or written and stay bitwise unchanged."""
    backend.require(rows.dim() == 1 and rows.shape[0] >= 1,
                    f"needs at least one live replica id, got shape {tuple(rows.shape)}")
    if not stack.is_cuda:
        return bmuf_update_rows_ref(stack, mean, w_global, velocity, rows, alpha, eta=eta,
                                    block_momentum=block_momentum, nesterov=nesterov,
                                    scale=scale)
    bmuf_rows(stack, mean, w_global, velocity, rows, alpha, eta * scale, block_momentum, nesterov)
    backend.count_launch(bmuf_sync_rows_op)
    return stack, w_global, velocity


bmuf_sync_rows_op.launches = 0
