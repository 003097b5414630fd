"""Launch of the hand-written CUDA BMUF landing kernel (csrc/bmuf_update.cu).

Replaces the TPU kernels ``bmuf_update`` and ``bmuf_update_rows`` of
``repro/kernels/bmuf_update/bmuf_update.py``: one entry point over a list of
replica ids (all ids, or the live ones).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def bmuf_rows(stack: torch.Tensor, mean: torch.Tensor, w_global: torch.Tensor,
              velocity: torch.Tensor, rows: torch.Tensor, alpha: float, eta_scale: float,
              block_momentum: float, nesterov: bool) -> None:
    """In place on stack (R, n, 128) f32 (the listed rows only), w_global and
    velocity (n, 128) f32; mean (n, 128) f32 is only read. rows: (A,) int32,
    A >= 1, on the same card."""
    dev = stack.device
    backend.require_cuda_tensor("stack", stack, torch.float32, 3)
    R, n, lanes = stack.shape
    for name, t in (("mean", mean), ("w_global", w_global), ("velocity", velocity)):
        backend.require_cuda_tensor(name, t, torch.float32, 2, device=dev)
        backend.require(t.shape == (n, lanes), f"{name} {tuple(t.shape)} != {(n, lanes)}")
    backend.require_cuda_tensor("rows", rows, torch.int32, 1, device=dev)
    backend.require(rows.shape[0] >= 1, "needs at least one replica id")
    backend.require(lanes % 4 == 0, f"lane width must be a multiple of 4, got {lanes}")
    planes = (stack, mean, w_global, velocity)
    backend.require(not any(backend.overlaps(a, b)
                            for i, a in enumerate(planes) for b in planes[i + 1:]),
                    "stack, mean, w_global and velocity must be separate buffers")
    fn = backend.c_function("bmuf_update", "bmuf_rows_f32", _ARGS)
    with torch.cuda.device(dev):
        err = fn(stack.data_ptr(), mean.data_ptr(), w_global.data_ptr(), velocity.data_ptr(),
                 rows.data_ptr(), rows.shape[0], R, n * lanes // 4, alpha, 1.0 - alpha,
                 eta_scale, block_momentum, int(bool(nesterov)), backend.stream_of(stack))
    backend.check_launch("bmuf_rows_f32", err)
