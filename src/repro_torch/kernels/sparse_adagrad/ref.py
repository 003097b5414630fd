"""Plain PyTorch version of the sparse-Adagrad kernel (twin of the JAX ref).

Duplicate rows scatter-ADD into the accumulator, and every occurrence's row
step is scaled by the FINAL accumulator (scatter-add first, gather after).
Unlike the JAX ref it updates ``table`` and ``acc`` in place, as the kernel
does (the TPU kernel aliases them too)."""
import torch


def sparse_adagrad_ref(table: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                       g_pooled: torch.Tensor, lr: float, eps: float = 1e-8):
    """table: (n_rows, d); acc: (n_rows, d) fp32; idx: (n_bags, m) row ids;
    g_pooled: (n_bags, d). Updates both in place and returns them."""
    m = idx.shape[1]
    rows = idx.reshape(-1).long()  # (n_bags * m,) occurrence order: bag-major
    g = g_pooled.float().repeat_interleave(m, dim=0)
    acc.index_add_(0, rows, g * g)
    scale = lr * torch.rsqrt(acc[rows] + eps)
    table.index_add_(0, rows, (-scale * g).to(table.dtype))
    return table, acc
