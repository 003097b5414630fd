"""Launch of the hand-written CUDA flash-attention kernels (csrc/flash_attention.cu).

Replaces the TPU kernel ``flash_attention`` of
``repro/kernels/flash_attention/flash_attention.py``: one launch computes
causal or full online-softmax attention for every (batch, head), reading
grouped KV heads in place and masking keys beyond S inside the kernel. The
dtype picks the kernel; both run on the tensor cores: bf16 through wgmma with
TMA loads, f32 through mma.sync in 3xTF32 (each operand split into two TF32
values, three products), which holds f32's accuracy.

The training form (bf16, head dim 64 or 128) adds what the TPU kernel does
not have: ``flash_attention_train_fwd`` runs the bf16 kernel with each query
row's log-sum-exp written beside the output, and ``flash_attention_train_bwd``
the backward kernels that take it (delta, then dK and dV, then dQ).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p]
_SYMBOL = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_TRAIN_FWD_ARGS = _ARGS[:4] + [ctypes.c_void_p] + _ARGS[4:]  # ... o, lse, B, ...
# q, k, v, o, do, lse, delta, dq, dk, dv, then B, ... as _ARGS
_TRAIN_BWD_ARGS = [ctypes.c_void_p] * 10 + _ARGS[4:]
HEAD_DIMS = (32, 64, 128)
TRAIN_HEAD_DIMS = (64, 128)  # the training form's kernels
MAX_GRID_Y = 65535  # the grid's y axis: (b, h) for f32, query tiles of 128 rows for bf16
BF16_QUERY_TILE = 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dims) -> tuple:
    """(B, S, H, Hkv, d) of q (B, S, H, d) and k, v (B, S, Hkv, d), once
    each is checked as the kernels take it."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        backend.require_cuda_tensor(name, t, q.dtype, 4, device=dev)
        backend.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    B, S, H, d = q.shape
    Hkv = k.shape[2]
    backend.require(k.shape == v.shape == (B, S, Hkv, d),
                    f"k {tuple(k.shape)} and v {tuple(v.shape)} must be {(B, S, Hkv, d)}")
    backend.require(Hkv > 0 and H % Hkv == 0, f"query heads {H} not a multiple of KV heads {Hkv}")
    backend.require(d in head_dims, f"head dim must be one of {head_dims}, got {d}")
    if q.dtype == torch.float32:
        backend.require(B * H <= MAX_GRID_Y, f"B*H = {B * H} exceeds the grid's {MAX_GRID_Y}")
    else:
        n_tiles = -(-S // BF16_QUERY_TILE)
        backend.require(n_tiles <= MAX_GRID_Y,
                        f"{n_tiles} query tiles exceed the grid's {MAX_GRID_Y}")
    return B, S, H, Hkv, d


def _strides(S: int, H: int, Hkv: int, d: int) -> tuple:
    """q's and k's strides between batches and positions, in elements."""
    return S * H * d, H * d, S * Hkv * d, Hkv * d


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d), H a multiple of Hkv; f32 or
    bf16 CUDA tensors, contiguous, 16-byte aligned, d in {32, 64, 128} ->
    (B, S, H, d) in q's dtype. Query head h reads KV head h // (H / Hkv)."""
    backend.require(q.dtype in _SYMBOL, f"q must be float32 or bfloat16, got {q.dtype}")
    B, S, H, Hkv, d = _check(q, k, v, HEAD_DIMS)
    out = torch.empty_like(q)
    symbol = _SYMBOL[q.dtype]
    fn = backend.c_function("flash_attention", symbol, _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, S, d,
                 *_strides(S, H, Hkv, d), int(causal), backend.stream_of(q))
    backend.check_launch(symbol, err)
    return out


def padded_rows(S: int) -> int:
    """Rows of a (B, H, S_pad) log-sum-exp: S rounded up to whole query tiles."""
    return -(-S // BF16_QUERY_TILE) * BF16_QUERY_TILE


def flash_attention_train_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True):
    """The bf16 kernel as ``gqa_flash_attention`` (bf16 only, d in {64,
    128}), and beside its output each query row's log2-sum-exp2 of the
    scaled scores, (B, H, padded_rows(S)) f32, which the backward reads."""
    backend.require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    B, S, H, Hkv, d = _check(q, k, v, TRAIN_HEAD_DIMS)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, padded_rows(S)), dtype=torch.float32, device=q.device)
    fn = backend.c_function("flash_attention", "flash_attention_fwd_bf16", _TRAIN_FWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, H, Hkv, S, d, *_strides(S, H, Hkv, d), int(causal), backend.stream_of(q))
    backend.check_launch("flash_attention_fwd_bf16", err)
    return out, lse


def flash_attention_train_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_train_fwd``'s output, given its
    ``out`` and ``lse`` and the output's gradient ``dout`` (as q, contiguous)."""
    B, S, H, Hkv, d = _check(q, k, v, TRAIN_HEAD_DIMS)
    backend.require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    for name, t in (("out", out), ("dout", dout)):
        backend.require_cuda_tensor(name, t, q.dtype, 4, device=q.device)
        backend.require(t.shape == q.shape, f"{name} {tuple(t.shape)} must be {tuple(q.shape)}")
        backend.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    backend.require_cuda_tensor("lse", lse, torch.float32, 3, device=q.device)
    backend.require(lse.shape == (B, H, padded_rows(S)),
                    f"lse {tuple(lse.shape)} must be {(B, H, padded_rows(S))}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = backend.c_function("flash_attention", "flash_attention_bwd_bf16", _TRAIN_BWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, H, Hkv, S, d, *_strides(S, H, Hkv, d), int(causal), backend.stream_of(q))
    backend.check_launch("flash_attention_bwd_bf16", err)
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, d) -> (BH, S, d), the reference kernel's signature
    (any S: keys beyond S are masked in the kernel, no padding)."""
    return gqa_flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]
