"""Public wrappers of the Model-Averaging kernels over flat replica space.

One launch per phase of the paper's background round: ``replica_mean_op`` at
sync launch (for the decentralized algorithms the snapshot IS the mean) and
``ma_sync_op`` at landing (the elastic pull-back). The ``*_rows_op`` pair are
their elastic-membership forms over the live replica ids only: dead rows are
never read or written and the mean divides by the live count. CUDA tensors
go through the hand-written kernels, CPU tensors through the plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ma_update.ma_update import (
    ma_pullback_all, ma_pullback_rows, replica_mean_rows)
from repro_torch.kernels.ma_update.ref import (
    ma_update_ref, ma_update_rows_ref, replica_mean_ref, replica_mean_rows_ref)


def _all_rows(stack: torch.Tensor) -> torch.Tensor:
    return backend.index_tensor(range(stack.shape[0]), stack.device)


def _need_rows(rows: torch.Tensor) -> None:
    backend.require(rows.dim() == 1 and rows.shape[0] >= 1,
                    f"needs at least one live replica id, got shape {tuple(rows.shape)}")


def replica_mean_op(stack: torch.Tensor) -> torch.Tensor:
    """(R, n, 128) replica buffer -> a new (n, 128) fp32 replica mean."""
    if not stack.is_cuda:
        return replica_mean_ref(stack)
    out = replica_mean_rows(stack, _all_rows(stack))
    backend.count_launch(replica_mean_op)
    return out


replica_mean_op.launches = 0  # kernel launches since the last reset


def replica_mean_rows_op(stack: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mean of only the LIVE rows of a (R, n, 128) buffer. ``rows``: (A,)
    int32 replica ids on the stack's device, A >= 1."""
    _need_rows(rows)
    if not stack.is_cuda:
        return replica_mean_rows_ref(stack, rows)
    out = replica_mean_rows(stack, rows)
    backend.count_launch(replica_mean_rows_op)
    return out


replica_mean_rows_op.launches = 0


def ma_sync_op(stack: torch.Tensor, mean: torch.Tensor, alpha: float, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pull every replica of a (R, n, 128) buffer toward ``mean``, one
    launch. In place on ``stack`` (the reference donates it), or, with
    ``out``, into that separate buffer with ``stack`` only read: the
    threaded round's pull-back, whose old planes trainers may still read."""
    if not stack.is_cuda:
        return ma_update_ref(stack, mean, alpha, out=out)
    got = ma_pullback_all(stack, stack if out is None else out, mean, alpha)
    backend.count_launch(ma_sync_op)
    return got


ma_sync_op.launches = 0


def ma_sync_rows_op(stack: torch.Tensor, mean: torch.Tensor, rows: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """Pull only the LIVE rows of a (R, n, 128) buffer toward ``mean``, in
    place; dead rows stay bitwise unchanged and are never read. ``rows`` made
    by ``backend.index_tensor`` (as the algorithms make them) reach the kernel
    from their host ids; any other tensor is read back first."""
    _need_rows(rows)
    if not stack.is_cuda:
        return ma_update_rows_ref(stack, mean, rows, alpha)
    got = ma_pullback_rows(stack, stack, mean, backend.host_ids(rows), alpha)
    backend.count_launch(ma_sync_rows_op)
    return got


ma_sync_rows_op.launches = 0
