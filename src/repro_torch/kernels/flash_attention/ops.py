"""Public wrapper: (B, S, H, d) GQA attention (twin of the JAX ``gqa_attention_op``).

A CUDA tensor goes through the hand-written kernel (``flash_attention.py``),
which reads grouped KV heads in place and needs no padding; a CPU tensor
through the plain version (``ref.py``), with the KV heads repeated and
(B, H) folded as the JAX wrapper does. There is no other path: a CUDA call
that the kernel cannot take raises. The kernel has no backward (nor has the
JAX package's: its ``flash_attention`` defines no VJP), and its ``ctypes``
launch returns a tensor outside autograd, so a CUDA input that needs a
gradient is refused rather than given none; training takes the plain
query-chunked attention (``models/layers.py::attention_apply(train=True)``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention.flash_attention import gqa_flash_attention
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref


def gqa_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d) -> (B, S, H, d) in q's dtype."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise RuntimeError(
                "gqa_attention_op: the flash-attention kernel has no backward (as in the JAX "
                "package); a CUDA input that requires grad would get no gradient. Train "
                "through attention_apply(train=True), or call under torch.no_grad()")
        out = gqa_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
        backend.count_launch(gqa_attention_op)
        return out
    return gqa_attention_ref(q, k, v, causal=causal)


gqa_attention_op.launches = 0  # kernel launches since the last reset
