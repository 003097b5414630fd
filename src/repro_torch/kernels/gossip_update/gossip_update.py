"""Launch of the hand-written CUDA gossip kernels (csrc/gossip_update.cu).

Replace the TPU kernels ``gossip_pair_update`` (one symmetric exchange of two
planes, out of place) and ``gossip_round_update`` (a round of pair landings
over the replica buffer, in place) of
``repro/kernels/gossip_update/gossip_update.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_PAIR_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_ROUND_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def gossip_pair_update(w_a: torch.Tensor, w_b: torch.Tensor, alpha: float):
    """w_a, w_b: (n, 128) f32 planes on one card -> (new_a, new_b), two new
    planes allocated on the current stream; the inputs are only read."""
    dev = w_a.device
    backend.require_cuda_tensor("w_a", w_a, torch.float32, 2)
    backend.require_cuda_tensor("w_b", w_b, torch.float32, 2, device=dev)
    backend.require(w_b.shape == w_a.shape, f"w_b {tuple(w_b.shape)} != w_a {tuple(w_a.shape)}")
    backend.require(w_a.shape[1] % 4 == 0,
                    f"lane width must be a multiple of 4, got {w_a.shape[1]}")
    new_a, new_b = torch.empty_like(w_a), torch.empty_like(w_b)
    fn = backend.c_function("gossip_update", "gossip_pair_f32", _PAIR_ARGS)
    with torch.cuda.device(dev):
        err = fn(w_a.data_ptr(), w_b.data_ptr(), new_a.data_ptr(), new_b.data_ptr(),
                 w_a.numel() // 4, alpha, 1.0 - alpha, backend.stream_of(w_a))
    backend.check_launch("gossip_pair_f32", err)
    return new_a, new_b


def gossip_round_update(stack: torch.Tensor, snapshot: torch.Tensor, land: torch.Tensor,
                        self_pos: torch.Tensor, partner_pos: torch.Tensor,
                        alpha: float) -> None:
    """In place on stack (R, n, 128) f32, the rows in ``land`` only.
    snapshot: (F, n, 128) f32, a separate buffer; land, self_pos,
    partner_pos: (P,) int32, P >= 1, on the same card."""
    dev = stack.device
    backend.require_cuda_tensor("stack", stack, torch.float32, 3)
    backend.require_cuda_tensor("snapshot", snapshot, torch.float32, 3, device=dev)
    R, n, lanes = stack.shape
    backend.require(snapshot.shape[1:] == (n, lanes),
                    f"snapshot {tuple(snapshot.shape)} does not hold ({n}, {lanes}) planes")
    P = land.shape[0] if land.dim() == 1 else -1
    for name, t in (("land", land), ("self_pos", self_pos), ("partner_pos", partner_pos)):
        backend.require_cuda_tensor(name, t, torch.int32, 1, device=dev)
        backend.require(t.shape == (P,), f"{name} {tuple(t.shape)} != ({P},)")
    backend.require(P >= 1, "needs at least one participant")
    backend.require(lanes % 4 == 0, f"lane width must be a multiple of 4, got {lanes}")
    backend.require(not backend.overlaps(snapshot, stack),
                    "snapshot must be a copy, not a view of the stack")
    fn = backend.c_function("gossip_update", "gossip_round_f32", _ROUND_ARGS)
    with torch.cuda.device(dev):
        err = fn(stack.data_ptr(), snapshot.data_ptr(), land.data_ptr(), self_pos.data_ptr(),
                 partner_pos.data_ptr(), P, R, snapshot.shape[0], n * lanes // 4, alpha,
                 1.0 - alpha, backend.stream_of(stack))
    backend.check_launch("gossip_round_f32", err)
