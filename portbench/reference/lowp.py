"""Products in a precision below the configuration's: the controls.

``mm(a, b, rnd, rnd_grad)`` is ``a @ b`` whose operands are rounded by
``rnd`` before the f32 product, and whose backward products round the
incoming gradient by ``rnd_grad`` as well, as a kernel in that precision
would read them; the product itself accumulates in f32.
"""
from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores read an f32 operand."""
    i = t.detach().float().contiguous().view(torch.int32)
    i = (i + ((i >> 13) & 1) + 0xFFF) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    t = t.detach().float()
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).float() * scale


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """Rounded to float8 e4m3, a scale a tensor (its largest magnitude at 448)."""
    return _fp8(t, torch.float8_e4m3fn, 448.0)


def e5m2(t: torch.Tensor) -> torch.Tensor:
    """Rounded to float8 e5m2 (gradients), a scale a tensor (largest at 57,344)."""
    return _fp8(t, torch.float8_e5m2, 57344.0)


class _RoundedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd, rnd_grad):
        a, b = rnd(a), rnd(b)
        ctx.save_for_backward(a, b)
        ctx.rnd_grad = rnd_grad
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ctx.rnd_grad(g)
        ga = g @ b.transpose(-1, -2)
        gb = a.transpose(-1, -2) @ g
        if gb.dim() > b.dim():  # b broadcast over leading dims
            gb = gb.reshape(-1, *b.shape).sum(0)
        return ga, gb, None, None


def mm(a, b, rnd, rnd_grad=None):
    return _RoundedMM.apply(a, b, rnd, rnd_grad or rnd)
