"""Launch of the hand-written CUDA sparse-Adagrad kernels (csrc/sparse_adagrad.cu).

Replaces the TPU kernels ``sparse_adagrad_rows`` and ``sparse_adagrad_blocked``
of ``repro/kernels/sparse_adagrad/sparse_adagrad.py``. One call launches two
kernels: the per-tile sums, then the combine of the runs that cross tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def tile_size() -> int:
    """Sorted occurrence positions a tile of the kernel (its ``TILE``)."""
    return backend.c_function("sparse_adagrad", "sparse_adagrad_tile_size", [])()


def sparse_adagrad_rows(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor,
                        order: torch.Tensor, m: int, g_pooled: torch.Tensor, *, lr: float,
                        eps: float = 1e-8) -> None:
    """In place on table/acc (n_rows, d) f32. rows: (n_items,) int32 sorted
    by row with a stable sort, and order: (n_items,) int64 the sort's
    permutation (so each row's occurrences keep their order); occurrence i's
    bag is ``order[i] // m``. g_pooled: (n_bags, d) f32."""
    dev = table.device
    backend.require_cuda_tensor("table", table, torch.float32, 2)
    backend.require_cuda_tensor("acc", acc, torch.float32, 2, device=dev)
    backend.require_cuda_tensor("rows", rows, torch.int32, 1, device=dev)
    backend.require_cuda_tensor("order", order, torch.int64, 1, device=dev)
    backend.require_cuda_tensor("g_pooled", g_pooled, torch.float32, 2, device=dev)
    n_rows, d = table.shape
    n_items = rows.shape[0]
    backend.require(acc.shape == table.shape, f"acc {tuple(acc.shape)} != table {tuple(table.shape)}")
    backend.require(g_pooled.shape[1] == d, f"g_pooled width {g_pooled.shape[1]} != {d}")
    backend.require(order.shape == rows.shape, "rows and order differ in length")
    backend.require(m >= 1 and n_items <= m * g_pooled.shape[0],
                    f"{n_items} occurrences do not fit {g_pooled.shape[0]} bags of {m}")
    backend.require(n_items < 2 ** 31, f"{n_items} occurrences: the kernel takes < 2^31")
    backend.require(d % 4 == 0, f"embedding dim must be a multiple of 4, got {d}")
    fn = backend.c_function("sparse_adagrad", "sparse_adagrad_rows_f32", _ARGS)
    n_tiles = -(-n_items // tile_size())
    with torch.cuda.device(dev):
        # one partial (sum g^2, sum g) per tile for a run entering it, one for a run leaving it
        partial = torch.empty((n_tiles, 2, 2, d), dtype=torch.float32, device=dev)
        err = fn(table.data_ptr(), acc.data_ptr(), rows.data_ptr(), order.data_ptr(), m,
                 g_pooled.data_ptr(), n_items, d, n_rows, lr, eps, partial.data_ptr(), n_tiles,
                 backend.stream_of(table))
    backend.check_launch("sparse_adagrad_rows_f32", err)
