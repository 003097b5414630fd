"""Data-sheet peaks of the card the benchmark runs on.

NVIDIA H100 80GB HBM3 (SXM), dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 495 TF32, 67
TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM. A card set below
700 W runs slower under load; every share is stated against these peaks,
with the card's power limit printed beside it in the result's ``device``.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

FLOPS_BY_DTYPE = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def bound_s(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
