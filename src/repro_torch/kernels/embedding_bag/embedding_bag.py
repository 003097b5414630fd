"""Launch of the hand-written CUDA embedding-bag kernel (csrc/embedding_bag.cu).

Replaces the TPU kernels ``embedding_bag`` and ``embedding_bag_blocked`` of
``repro/kernels/embedding_bag/embedding_bag.py``: one launch gathers and
sum-pools every bag.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (rows, d) f32 CUDA; idx: (n_bags, m) int32 CUDA -> (n_bags, d) f32."""
    backend.require_cuda_tensor("table", table, torch.float32, 2)
    backend.require_cuda_tensor("idx", idx, torch.int32, 2, device=table.device)
    n_rows, d = table.shape
    n_bags, m = idx.shape
    backend.require(d % 4 == 0, f"embedding dim must be a multiple of 4, got {d}")
    out = torch.empty((n_bags, d), dtype=torch.float32, device=table.device)
    fn = backend.c_function("embedding_bag", "embedding_bag_f32", _ARGS)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_bags, m, d, n_rows,
                 backend.stream_of(table))
    backend.check_launch("embedding_bag_f32", err)
    return out
