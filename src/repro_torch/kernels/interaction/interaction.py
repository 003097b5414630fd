"""Launch of the hand-written CUDA interaction kernel (csrc/interaction.cu).

Replaces the TPU kernel ``interaction`` of
``repro/kernels/interaction/interaction.py``: one launch writes every
sample's upper-triangle pairwise dots without building the Gram matrix.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
_SYMBOL = {torch.float32: "interaction_f32", torch.bfloat16: "interaction_bf16"}
SMEM_MAX = 227 * 1024


def _one_sample_smem_bytes(F: int, d: int) -> int:
    """Shared memory of a one-sample tile (csrc/interaction.cu's Geometry):
    its z rows padded to a multiple of 4 floats and the sample to an odd
    number of float4s, its F(F-1)/2 outputs, the table of 4x4 blocks."""
    dp = -(-d // 4) * 4
    sp4 = F * dp // 4
    nb = -(-F // 4)
    return 4 * (4 * (sp4 + (sp4 % 2 == 0)) + F * (F - 1) // 2 + nb * (nb + 1) // 2)


def interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, d) f32 or bf16 CUDA, contiguous -> (B, F*(F-1)/2) f32."""
    backend.require(z.dtype in _SYMBOL, f"z must be float32 or bfloat16, got {z.dtype}")
    backend.require_cuda_tensor("z", z, z.dtype, 3)
    B, F, d = z.shape
    backend.require(F >= 2, f"need at least two features, got {F}")
    backend.require(_one_sample_smem_bytes(F, d) <= SMEM_MAX,
                    f"one sample's {F}x{d} features exceed a block's shared memory")
    out = torch.empty((B, F * (F - 1) // 2), dtype=torch.float32, device=z.device)
    symbol = _SYMBOL[z.dtype]
    fn = backend.c_function("interaction", symbol, _ARGS)
    with torch.cuda.device(z.device):
        err = fn(z.data_ptr(), out.data_ptr(), B, F, d, backend.stream_of(z))
    backend.check_launch(symbol, err)
    return out
