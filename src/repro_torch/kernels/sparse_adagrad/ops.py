"""Public wrapper of the sparse-Adagrad kernel.

CUDA tensors go through the hand-written kernel: the wrapper lists the
(bag, hot) occurrences, sorts them by row with a stable sort, and the kernel
gives each run of equal rows to one thread group. CPU tensors go through the
plain version. Both update ``table`` and ``acc`` in place.
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
    rows, order = torch.sort(flat_idx.reshape(-1).to(torch.int32), stable=True)
    bags = torch.div(order, m, rounding_mode="floor").to(torch.int32)
    sparse_adagrad_rows(table, acc, rows, bags, g.float().contiguous(), lr=lr, eps=eps)
    backend.count_launch(sparse_adagrad_op)
    return table, acc


sparse_adagrad_op.launches = 0  # kernel launches since the last reset
