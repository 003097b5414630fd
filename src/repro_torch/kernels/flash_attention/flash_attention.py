"""Launch of the hand-written CUDA flash-attention kernels (csrc/flash_attention.cu).

Replaces the TPU kernel ``flash_attention`` of
``repro/kernels/flash_attention/flash_attention.py``: one launch computes
causal or full online-softmax attention for every (batch, head), reading
grouped KV heads in place and masking keys beyond S inside the kernel. The
dtype picks the kernel; both run on the tensor cores: bf16 through wgmma with
TMA loads, f32 through mma.sync in 3xTF32 (each operand split into two TF32
values, three products), which holds f32's accuracy.
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
HEAD_DIMS = (32, 64, 128)
MAX_GRID_Y = 65535  # the grid's y axis: (b, h) for f32, query tiles of 128 rows for bf16
BF16_QUERY_TILE = 128


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d), H a multiple of Hkv; f32 or
    bf16 CUDA tensors, contiguous, 16-byte aligned, d in {32, 64, 128} ->
    (B, S, H, d) in q's dtype. Query head h reads KV head h // (H / Hkv)."""
    backend.require(q.dtype in _SYMBOL, f"q must be float32 or bfloat16, got {q.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        backend.require_cuda_tensor(name, t, q.dtype, 4, device=dev)
        backend.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    B, S, H, d = q.shape
    Hkv = k.shape[2]
    backend.require(k.shape == v.shape == (B, S, Hkv, d),
                    f"k {tuple(k.shape)} and v {tuple(v.shape)} must be {(B, S, Hkv, d)}")
    backend.require(Hkv > 0 and H % Hkv == 0, f"query heads {H} not a multiple of KV heads {Hkv}")
    backend.require(d in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}, got {d}")
    if q.dtype == torch.float32:
        backend.require(B * H <= MAX_GRID_Y, f"B*H = {B * H} exceeds the grid's {MAX_GRID_Y}")
    else:
        n_tiles = -(-S // BF16_QUERY_TILE)
        backend.require(n_tiles <= MAX_GRID_Y,
                        f"{n_tiles} query tiles exceed the grid's {MAX_GRID_Y}")
    out = torch.empty_like(q)
    symbol = _SYMBOL[q.dtype]
    fn = backend.c_function("flash_attention", symbol, _ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, S, d,
                 S * H * d, H * d, S * Hkv * d, Hkv * d, int(causal), backend.stream_of(q))
    backend.check_launch(symbol, err)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, d) -> (BH, S, d), the reference kernel's signature
    (any S: keys beyond S are masked in the kernel, no padding)."""
    return gqa_flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]
