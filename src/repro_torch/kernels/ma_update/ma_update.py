"""Launch of the hand-written CUDA Model-Averaging kernels (csrc/ma_update.cu).

Replace the TPU kernels ``replica_mean``, ``replica_mean_rows``,
``ma_update`` and ``ma_update_rows`` of
``repro/kernels/ma_update/ma_update.py``: the mean over a device list of
replica ids (all ids for the full-cohort kernel, the live ids for the
elastic one), and the pull-back of every row or of a host list of ids.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import backend

_MEAN_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_void_p]
_ALL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_PULL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
              ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
              ctypes.c_void_p]


@functools.lru_cache(maxsize=256)
def _c_ids(ids: Tuple[int, ...]):
    """A host id list as the C array the pull-back entry point copies into
    its launch parameters (a handful of memberships: made once each)."""
    return (ctypes.c_int * len(ids))(*ids)


def _check_stack_rows(stack: torch.Tensor, rows: torch.Tensor) -> None:
    backend.require_cuda_tensor("stack", stack, torch.float32, 3)
    backend.require_cuda_tensor("rows", rows, torch.int32, 1, device=stack.device)
    backend.require(stack.shape[2] % 4 == 0,
                    f"lane width must be a multiple of 4, got {stack.shape[2]}")
    backend.require(rows.shape[0] >= 1, "needs at least one replica id")


def replica_mean_rows(stack: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """stack (R, n, 128) f32, rows (A,) int32 on the same card -> a new
    (n, 128) f32 plane: the mean of the listed replicas."""
    _check_stack_rows(stack, rows)
    R, n, lanes = stack.shape
    out = torch.empty((n, lanes), dtype=torch.float32, device=stack.device)
    fn = backend.c_function("ma_update", "replica_mean_rows_f32", _MEAN_ARGS)
    with torch.cuda.device(stack.device):
        err = fn(stack.data_ptr(), rows.data_ptr(), rows.shape[0], R, out.data_ptr(),
                 n * lanes // 4, backend.stream_of(stack))
    backend.check_launch("replica_mean_rows_f32", err)
    return out


def _check_pullback(src: torch.Tensor, dst: torch.Tensor, mean: torch.Tensor) -> None:
    backend.require_cuda_tensor("src", src, torch.float32, 3)
    backend.require(src.shape[2] % 4 == 0, f"lane width must be a multiple of 4, got {src.shape[2]}")
    backend.require_cuda_tensor("dst", dst, torch.float32, 3, device=src.device)
    backend.require_cuda_tensor("mean", mean, torch.float32, 2, device=src.device)
    backend.require(dst.shape == src.shape, f"dst {tuple(dst.shape)} != src {tuple(src.shape)}")
    backend.require(mean.shape == src.shape[1:], f"mean {tuple(mean.shape)} != {tuple(src.shape[1:])}")
    backend.require(dst.data_ptr() == src.data_ptr() or not backend.overlaps(dst, src),
                    "dst must be src itself or a separate buffer")
    backend.require(not backend.overlaps(mean, src) and not backend.overlaps(mean, dst),
                    "mean must be a separate plane, not a view of the stack")


def ma_pullback_all(src: torch.Tensor, dst: torch.Tensor, mean: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """dst = (1-alpha) src + alpha mean over every row, one launch. ``dst``
    is ``src`` (in place) or a buffer of the same shape that does not
    overlap it (out of place)."""
    _check_pullback(src, dst, mean)
    R, n, lanes = src.shape
    fn = backend.c_function("ma_update", "ma_pullback_all_f32", _ALL_ARGS)
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), dst.data_ptr(), mean.data_ptr(), R, n * lanes // 4, alpha,
                 1.0 - alpha, backend.stream_of(src))
    backend.check_launch("ma_pullback_all_f32", err)
    return dst


def ma_pullback_rows(src: torch.Tensor, dst: torch.Tensor, mean: torch.Tensor,
                     ids: Sequence[int], alpha: float) -> torch.Tensor:
    """dst[ids] = (1-alpha) src[ids] + alpha mean, one launch per 64 ids.
    ``ids`` are host ints (the kernel takes them as a launch parameter, so
    nothing is read from the card before the planes); rows outside ``ids``
    are not written."""
    _check_pullback(src, dst, mean)
    ids = tuple(int(i) for i in ids)
    backend.require(len(ids) >= 1, "needs at least one replica id")
    R, n, lanes = src.shape
    fn = backend.c_function("ma_update", "ma_pullback_rows_f32", _PULL_ARGS)
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), dst.data_ptr(), mean.data_ptr(), _c_ids(ids), len(ids), R,
                 n * lanes // 4, alpha, 1.0 - alpha, backend.stream_of(src))
    backend.check_launch("ma_pullback_rows_f32", err)
    return dst
