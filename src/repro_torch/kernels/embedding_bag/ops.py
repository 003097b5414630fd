"""Public wrapper of the embedding-bag kernel.

A CUDA table goes through the hand-written kernel (``embedding_bag.py``); a
CPU table through the plain version (``ref.py``). There is no other path: a
CUDA call that the kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag_op(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (rows, d); idx: (..., m) -> (..., d) sum-pooled lookups."""
    flat_idx = idx.reshape(-1, idx.shape[-1])
    if table.is_cuda:
        out = embedding_bag(table, flat_idx.to(torch.int32).contiguous())
        backend.count_launch(embedding_bag_op)
    else:
        out = embedding_bag_ref(table, flat_idx)
    return out.reshape(*idx.shape[:-1], table.shape[-1])


embedding_bag_op.launches = 0  # kernel launches since the last reset
