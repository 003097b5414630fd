"""Public wrappers: (B, S, H, d) GQA attention (twin of the JAX
``gqa_attention_op``) and its differentiable training form.

``gqa_attention_op``, the prefill form: a CUDA tensor goes through the
hand-written kernel (``flash_attention.py``), which reads grouped KV heads
in place and needs no padding; a CPU tensor through the plain version
(``ref.py``), with the KV heads repeated and (B, H) folded as the JAX
wrapper does. There is no other path: a CUDA call that the kernel cannot
take raises. Its ``ctypes`` launch returns a tensor outside autograd, so a
CUDA input that needs a gradient is refused rather than given none.
A ``meta`` tensor is a dry run's stand-in for the card
(``launch/dryrun.py``): the call gives the output's shape and reports the
kernel's work to the trace (``backend.tracing``) instead of the plain
version's, which the card never runs.

``attention_train_op``, the training form (bf16, d in {64, 128}; the JAX
package has none: its ``flash_attention`` defines no VJP and its training
attention is plain ``jnp``): one ``torch.autograd.Function`` whose forward
is the bf16 kernel with each row's log-sum-exp kept, and whose backward
(``attention_train_bwd``) the hand-written backward kernels. It saves q, k,
v, the output and the log-sum-exp, nothing of size S². It runs on the card
only; on meta tensors each pass reports its kernels' work to a dry run's
trace, as the prefill form does.
``models/layers.py::_chunked_attention`` sends the card's bf16
self-attention here and everything else (the CPU among it) to the plain
query-chunked path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_train_bwd, flash_attention_train_fwd, gqa_flash_attention, padded_rows)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref


def gqa_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d) -> (B, S, H, d) in q's dtype."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise RuntimeError(
                "gqa_attention_op: the prefill kernel has no backward (as in the JAX "
                "package); a CUDA input that requires grad would get no gradient. Train "
                "through attention_train_op (attention_apply(train=True)), or call under "
                "torch.no_grad()")
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


def _train_work(q: torch.Tensor, k: torch.Tensor, causal: bool, backward: bool):
    """(FLOPs, bytes) of one pass of the training form. The forward: the
    prefill kernel's work (``_kernel_work``) and the log-sum-exp written.
    The backward: five products of the forward's size (s, dp, dV, dK, dQ;
    the dQ pass's recompute of s and dp is not work), q, k, v, the output
    and its gradient read once, dq, dk and dv written once (twice the
    forward's operands), the log-sum-exp read, the row sums written and
    read."""
    flops, nbytes = _kernel_work(q, k, causal)
    B, S, H, _ = q.shape
    plane = 4 * B * H * padded_rows(S)  # one f32 (B, H, S_pad) row statistic
    if backward:
        return 5 * flops // 2, 2 * nbytes + 3 * plane
    return flops, nbytes + plane


class _TrainingAttention(torch.autograd.Function):
    """The training form on the card: the forward kernel, then the backward
    kernels on the saved q, k, v, output and log-sum-exp. On meta tensors
    each pass counts its kernels' work (``backend.trace_work``) and gives
    its outputs' shapes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_meta:
            backend.trace_work("flash_attention_train_fwd", *_train_work(q, k, causal, False))
            out = torch.empty_like(q)
            lse = q.new_empty((q.shape[0], q.shape[2], padded_rows(q.shape[1])),
                              dtype=torch.float32)
        else:
            out, lse = flash_attention_train_fwd(q, k, v, causal=causal)
            backend.count_launch(attention_train_op)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_meta:
            backend.trace_work("flash_attention_train_bwd", *_train_work(q, k, ctx.causal, True))
            return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None
        dq, dk, dv = attention_train_bwd(q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None


def attention_train_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d) bf16 CUDA tensors, d in {64,
    128} -> (B, S, H, d), differentiable in q, k and v. Meta tensors (a dry
    run's trace) give the output's shape and count the kernels' work. The
    CPU has no such kernel: it trains through the plain path."""
    backend.require(q.is_cuda or q.is_meta,
                    f"attention_train_op: no training kernel on {q.device.type}; the plain "
                    "path (models/layers.py::_attend) trains there")
    return _TrainingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def attention_train_bwd(q, k, v, out, lse, dout, *, causal: bool = True):
    """(dq, dk, dv) of ``attention_train_op``'s output: one launch of the
    backward kernels (delta, dK and dV, dQ)."""
    grads = flash_attention_train_bwd(q, k, v, out, lse, dout.contiguous(), causal=causal)
    backend.count_launch(attention_train_bwd)
    return grads


attention_train_op.launches = 0  # forward launches since the last reset
attention_train_bwd.launches = 0  # backward launches since the last reset
