"""Launch of the hand-written CUDA EASGD kernels (csrc/easgd_update.cu).

Replace the TPU kernels ``easgd_round_update`` (the masked sequential round,
in place) and ``easgd_update`` (one PS<->replica pair exchange, out of place)
of ``repro/kernels/easgd_update/easgd_update.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_PAIR_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


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
    backend.require(not backend.overlaps(snapshot, stack) and not backend.overlaps(snapshot, w_ps),
                    "snapshot must be a copy, not a view of the stack or the PS plane")
    fn = backend.c_function("easgd_update", "easgd_round_f32", _ARGS)
    with torch.cuda.device(dev):
        err = fn(stack.data_ptr(), w_ps.data_ptr(), snapshot.data_ptr(), fired.data_ptr(), F, R,
                 n * lanes, alpha, 1.0 - alpha, backend.stream_of(stack))
    backend.check_launch("easgd_round_f32", err)


def easgd_update(w_ps: torch.Tensor, w_i: torch.Tensor, alpha: float):
    """w_ps, w_i: (n, 128) f32 planes on one card -> (new_ps, new_wi), two
    new planes allocated on the current stream; the inputs are only read."""
    dev = w_ps.device
    backend.require_cuda_tensor("w_ps", w_ps, torch.float32, 2)
    backend.require_cuda_tensor("w_i", w_i, torch.float32, 2, device=dev)
    backend.require(w_i.shape == w_ps.shape, f"w_i {tuple(w_i.shape)} != w_ps {tuple(w_ps.shape)}")
    backend.require(w_ps.shape[1] % 4 == 0, f"lane width must be a multiple of 4, got {w_ps.shape[1]}")
    new_ps, new_wi = torch.empty_like(w_ps), torch.empty_like(w_i)
    fn = backend.c_function("easgd_update", "easgd_pair_f32", _PAIR_ARGS)
    with torch.cuda.device(dev):
        err = fn(w_ps.data_ptr(), w_i.data_ptr(), new_ps.data_ptr(), new_wi.data_ptr(),
                 w_ps.numel(), alpha, 1.0 - alpha, backend.stream_of(w_ps))
    backend.check_launch("easgd_pair_f32", err)
    return new_ps, new_wi
