"""Public wrapper of the sparse-Adagrad kernel.

CUDA tensors go through the hand-written kernel: the wrapper sorts the
(bag, hot) occurrences with a stable sort and hands the kernel the sorted
ids and the sort's permutation; the kernel cuts the sorted list into fixed
tiles, so no run of a hot row is walked by one thread group. CPU tensors go
through the plain version. Both update ``table`` and ``acc`` in place.

The sort key is the ids themselves unless ``order_ids`` gives another of
the same shape: the tiered cache (``embeddings/cache.py``) updates a hot
tier whose slots are not in row order, and sorts by the row ids. Where a
run of equal ids starts in the sorted list decides which runs cross a
tile, and so the order in which the kernel adds a run's terms; sorting by
row puts every run, tile and sum where the launch on the full table puts
them, so the cached update is bitwise the uncached one. The kernel only
compares neighbouring ids, so they need not ascend.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref
from repro_torch.kernels.sparse_adagrad.sparse_adagrad import sparse_adagrad_rows


def sort_occurrences(ids: torch.Tensor, order_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids in sorted order as int32, the stable sort's permutation) for the
    kernel: the occurrences sorted by ``order_ids`` (default: ``ids``) and
    ``ids`` permuted by that sort. Runs on any device."""
    flat = ids.reshape(-1).to(torch.int32)
    if order_ids is None:
        return torch.sort(flat, stable=True)
    if order_ids.shape != ids.shape:
        raise ValueError(f"order_ids {tuple(order_ids.shape)} != ids {tuple(ids.shape)}")
    _, order = torch.sort(order_ids.reshape(-1).to(torch.int32), stable=True)
    return flat[order], order


def sparse_adagrad_op(table: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                      g_pooled: torch.Tensor, *, lr: float, eps: float = 1e-8,
                      order_ids: Optional[torch.Tensor] = None):
    """table: (n_rows, d); acc: (n_rows, d) fp32; idx: (..., m) row ids;
    g_pooled: (..., d) pooled grads, bag dims matching idx's; order_ids:
    None, or the sort key of each occurrence, idx's shape (the plain version
    ignores it: it adds in occurrence order). Updates in place and returns
    (table, acc)."""
    m = idx.shape[-1]
    flat_idx = idx.reshape(-1, m)
    g = g_pooled.reshape(-1, g_pooled.shape[-1])
    if order_ids is not None and order_ids.shape != idx.shape:
        raise ValueError(f"order_ids {tuple(order_ids.shape)} != idx {tuple(idx.shape)}")
    if not table.is_cuda:
        return sparse_adagrad_ref(table, acc, flat_idx, g, lr, eps)
    if flat_idx.numel() == 0:  # no occurrence: nothing to launch
        return table, acc
    rows, order = sort_occurrences(flat_idx, None if order_ids is None
                                   else order_ids.reshape(flat_idx.shape))
    sparse_adagrad_rows(table, acc, rows, order, m, g.float().contiguous(), lr=lr, eps=eps)
    backend.count_launch(sparse_adagrad_op)
    return table, acc


sparse_adagrad_op.launches = 0  # kernel launches since the last reset
