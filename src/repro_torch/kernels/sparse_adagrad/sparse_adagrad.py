"""Launch of the hand-written CUDA sparse-Adagrad kernel (csrc/sparse_adagrad.cu).

Replaces the TPU kernels ``sparse_adagrad_rows`` and ``sparse_adagrad_blocked``
of ``repro/kernels/sparse_adagrad/sparse_adagrad.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
         ctypes.c_void_p]


def sparse_adagrad_rows(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor,
                        bags: torch.Tensor, g_pooled: torch.Tensor, *, lr: float,
                        eps: float = 1e-8) -> None:
    """In place on table/acc (n_rows, d) f32. rows/bags: (n_items,) int32,
    sorted by row (stable, so each row's occurrences keep their order);
    g_pooled: (n_bags, d) f32."""
    dev = table.device
    backend.require_cuda_tensor("table", table, torch.float32, 2)
    backend.require_cuda_tensor("acc", acc, torch.float32, 2, device=dev)
    backend.require_cuda_tensor("rows", rows, torch.int32, 1, device=dev)
    backend.require_cuda_tensor("bags", bags, torch.int32, 1, device=dev)
    backend.require_cuda_tensor("g_pooled", g_pooled, torch.float32, 2, device=dev)
    n_rows, d = table.shape
    backend.require(acc.shape == table.shape, f"acc {tuple(acc.shape)} != table {tuple(table.shape)}")
    backend.require(g_pooled.shape[1] == d, f"g_pooled width {g_pooled.shape[1]} != {d}")
    backend.require(rows.shape == bags.shape, "rows and bags differ in length")
    backend.require(d % 4 == 0, f"embedding dim must be a multiple of 4, got {d}")
    fn = backend.c_function("sparse_adagrad", "sparse_adagrad_rows_f32", _ARGS)
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), acc.data_ptr(), rows.data_ptr(), bags.data_ptr(),
                 g_pooled.data_ptr(), rows.shape[0], d, n_rows, lr, eps, backend.stream_of(table))
    backend.check_launch("sparse_adagrad_rows_f32", err)
