"""The card's roofline constants and the mesh descriptions the spec rules
read (the twin of ``repro/launch/mesh.py``).

The port computes on one card, in one process: it builds no device mesh and
shards nothing. A ``Mesh`` here is a description only (axis names and their
sizes), so that ``sharding/rules.py`` and ``launch/specs.py`` give the
placements the reference's production meshes would; it holds no devices.

The constants are data-sheet figures for the **NVIDIA H100 80GB HBM3 (SXM),
700 W**, not measurements: dense bf16 tensor-core peak, HBM3 bandwidth, and
NVLink 4's 900 GB/s per GPU, half of it each way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 (H100 SXM data sheet)
HBM_BW = 3.35e12  # B/s (H100 SXM data sheet)
LINK_BW = 450e9  # B/s per direction, NVLink 4 (H100 SXM data sheet)
HBM_BYTES = 80e9  # the card's device memory (H100 80GB)


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in the reference's order; no devices."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, the form the rules read (the reference's
        ``dict(zip(mesh.axis_names, mesh.devices.shape))``)."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16), axes (data, model). Multi-pod: (2, 16, 16),
    axes (pod, data, model); ShadowSync's replicas live on the pod axis."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (data, model) mesh, for tests and examples."""
    return Mesh(("data", "model"), (data, model))
