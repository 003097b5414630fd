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
A ``meta`` tensor is a dry run's stand-in for the card
(``launch/dryrun.py``): the call gives the output's shape and reports the
kernel's work to the trace (``backend.tracing``) instead of the plain
version's, which the card never runs.
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
    if q.is_meta:
        backend.trace_work("flash_attention", *_kernel_work(q, k, causal))
        return torch.empty_like(q)
    return gqa_attention_ref(q, k, v, causal=causal)


def _kernel_work(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """(FLOPs, bytes) of one launch: the scores and the products over the
    (causal) query-key pairs, q, k and v read once, the output written
    once."""
    B, S, H, d = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * d * B * H * pairs, (2 * q.numel() + 2 * k.numel()) * q.element_size()


gqa_attention_op.launches = 0  # kernel launches since the last reset
