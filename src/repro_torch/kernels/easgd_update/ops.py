"""Public wrapper of the EASGD round kernel over flat replica space.

A sync is one launch over the persistent (R, n, 128) buffer (core/flatspace.py),
in place on the stack and the PS plane. CUDA tensors go through the
hand-written kernel, CPU tensors through the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.easgd_update.easgd_update import easgd_round_update
from repro_torch.kernels.easgd_update.ref import easgd_round_ref


def easgd_round_op(stack: torch.Tensor, w_ps: torch.Tensor, snapshot: torch.Tensor,
                   fired: torch.Tensor, alpha: float):
    """Masked sequential round. ``fired``: (F,) int32 replica ids in exchange
    order; ``snapshot``: (F, n, 128) launch copies of exactly the fired
    replicas (positional), never a view of the live stack. Updates ``stack``
    and ``w_ps`` in place; rows not in ``fired`` are untouched. Returns them."""
    if not stack.is_cuda:
        return easgd_round_ref(stack, w_ps, snapshot, fired, alpha)
    easgd_round_update(stack, w_ps, snapshot, fired, alpha)
    easgd_round_op.launches += 1
    return stack, w_ps


easgd_round_op.launches = 0  # kernel launches since the last reset
