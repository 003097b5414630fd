"""Launch of the hand-written CUDA EASGD round kernel (csrc/easgd_update.cu).

Replaces the TPU kernel ``easgd_round_update`` of
``repro/kernels/easgd_update/easgd_update.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def easgd_round_update(stack: torch.Tensor, w_ps: torch.Tensor, snapshot: torch.Tensor,
                       fired: torch.Tensor, alpha: float) -> None:
    """In place on stack (R, n, 128) f32 and w_ps (n, 128) f32. snapshot:
    (F, n, 128) f32, a separate buffer; fired: (F,) int32 on the same card."""
    dev = stack.device
    backend.require_cuda_tensor("stack", stack, torch.float32, 3)
    backend.require_cuda_tensor("w_ps", w_ps, torch.float32, 2, device=dev)
    backend.require_cuda_tensor("snapshot", snapshot, torch.float32, 3, device=dev)
    backend.require_cuda_tensor("fired", fired, torch.int32, 1, device=dev)
    R, n, lanes = stack.shape
    F = fired.shape[0]
    backend.require(w_ps.shape == (n, lanes), f"w_ps {tuple(w_ps.shape)} != {(n, lanes)}")
    backend.require(snapshot.shape == (F, n, lanes),
                    f"snapshot {tuple(snapshot.shape)} != {(F, n, lanes)}")
    backend.require(lanes % 4 == 0, f"lane width must be a multiple of 4, got {lanes}")
    backend.require(not _overlaps(snapshot, stack) and not _overlaps(snapshot, w_ps),
                    "snapshot must be a copy, not a view of the stack or the PS plane")
    fn = backend.c_function("easgd_update", "easgd_round_f32", _ARGS)
    with torch.cuda.device(dev):
        err = fn(stack.data_ptr(), w_ps.data_ptr(), snapshot.data_ptr(), fired.data_ptr(), F, R,
                 n * lanes, alpha, 1.0 - alpha, backend.stream_of(stack))
    backend.check_launch("easgd_round_f32", err)
