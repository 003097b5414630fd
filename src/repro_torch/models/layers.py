"""Layer helpers (the part of ``repro/models/layers.py`` that DLRM needs)."""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Normal(0, 1) * d_in**-0.5, drawn from ``gen`` (a CPU generator, so the
    weights do not depend on the device they are moved to)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)
