"""Public wrapper of the sparse-Adagrad kernel.

CUDA tensors go through the hand-written kernel: the wrapper sorts the
(bag, hot) occurrences by row with a stable sort and hands the kernel the
sorted ids and the sort's permutation; the kernel cuts the sorted list into
fixed tiles, so no run of a hot row is walked by one thread group. CPU
tensors go through the plain version. Both update ``table`` and ``acc`` in
place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref
from repro_torch.kernels.sparse_adagrad.sparse_adagrad import sparse_adagrad_rows


def sparse_adagrad_op(table: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                      g_pooled: torch.Tensor, *, lr: float, eps: float = 1e-8):
    """table: (n_rows, d); acc: (n_rows, d) fp32; idx: (..., m) row ids;
    g_pooled: (..., d) pooled grads, bag dims matching idx's.
    Updates in place and returns (table, acc)."""
    m = idx.shape[-1]
    flat_idx = idx.reshape(-1, m)
    g = g_pooled.reshape(-1, g_pooled.shape[-1])
    if not table.is_cuda:
        return sparse_adagrad_ref(table, acc, flat_idx, g, lr, eps)
    if flat_idx.numel() == 0:  # no occurrence: nothing to launch
        return table, acc
    rows, order = torch.sort(flat_idx.reshape(-1).to(torch.int32), stable=True)
    sparse_adagrad_rows(table, acc, rows, order, m, g.float().contiguous(), lr=lr, eps=eps)
    backend.count_launch(sparse_adagrad_op)
    return table, acc


sparse_adagrad_op.launches = 0  # kernel launches since the last reset
