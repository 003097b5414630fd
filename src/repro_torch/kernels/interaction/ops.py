"""Public wrapper of the interaction kernel (twin of the JAX ``interaction_op``).

A CUDA tensor goes through the hand-written kernel (``interaction.py``), for
any batch size (no padding to a tile); a CPU tensor through the plain version
(``ref.py``). There is no other path. As in the reference, the DLRM model
itself computes these dots with a plain product (``models/dlrm.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.interaction.interaction import interaction
from repro_torch.kernels.interaction.ref import interaction_ref


def interaction_op(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, d) -> (B, F*(F-1)/2) f32 pairwise dots (i < j)."""
    if z.is_cuda:
        out = interaction(z.contiguous())
        backend.count_launch(interaction_op)
        return out
    return interaction_ref(z)


interaction_op.launches = 0  # kernel launches since the last reset
