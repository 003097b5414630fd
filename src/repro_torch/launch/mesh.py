"""The card's roofline constants, the mesh descriptions the spec rules read,
and the device meshes the mesh program runs on (the twin of
``repro/launch/mesh.py``).

A ``Mesh`` is a description (axis names and their sizes): ``sharding/rules.py``
and ``launch/specs.py`` read it to give the placements of the reference's
production meshes, and the one-card program reads nothing else. The mesh
program runs on a ``torch.distributed`` ``DeviceMesh`` built from a ``Mesh``
over the running process group (``device_mesh``): a fake process group of
``n`` ranks in this one process (``fake_world``) for the dry run's 256- and
512-chip meshes, as the reference forces 512 host devices; ``gloo`` ranks on
the CPU; ``nccl`` on the card. Nothing here starts a process group at import.

The constants are data-sheet figures for the **NVIDIA H100 80GB HBM3 (SXM),
700 W**, not measurements: dense bf16 tensor-core peak, HBM3 bandwidth, and
NVLink 4's 900 GB/s per GPU, half of it each way.
"""
from __future__ import annotations

import math
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

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16), axes (data, model). Multi-pod: (2, 16, 16),
    axes (pod, data, model); ShadowSync's replicas live on the pod axis."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (data, model) mesh, for tests and examples."""
    return Mesh(("data", "model"), (data, model))


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (a ``Mesh`` is a description)."""
    return not isinstance(mesh, Mesh) and hasattr(mesh, "mesh_dim_names")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``Mesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def describe(device_mesh) -> Mesh:
    """The ``Mesh`` description of a ``DeviceMesh``."""
    return Mesh(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.shape))


def fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks in this process, as rank 0:
    its collectives move no data, so one process traces one rank's program
    of an ``n``-chip mesh. A running fake group of another size is
    destroyed first; any other running group is an error."""
    import torch.distributed as dist

    try:  # the fake backend's store lives in a private module
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg): the mesh dry run "
                           "needs it; --one-card traces without one") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; the fake "
                               "world would replace it")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s axes over the running process group,
    whose world must be the mesh's size: ``device_type`` "cpu" (a fake or
    ``gloo`` group) or "cuda" (``nccl``). Raises without a process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (fake_world, or "
                           "torch.distributed.init_process_group) before building a device mesh")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {dict(mesh.shape)} needs {mesh.size} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(mesh.axis_sizes),
                            mesh_dim_names=tuple(mesh.axis_names))
