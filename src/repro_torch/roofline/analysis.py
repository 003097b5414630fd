"""Roofline terms of the dry run, the collectives of a mesh program, and
model FLOPs (the twin of ``repro/roofline/analysis.py``).

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = bytes moved / HBM bandwidth
    collective term = collective bytes per chip / link bandwidth

over the NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet constants of
``launch/mesh.py`` (the link: NVLink 4, 450 GB/s a direction). The counts
come from ``launch/dryrun.py::_trace_cost``, which runs the port's own step
once on ``meta`` tensors and counts what that program executes
(``TraceCost``), where the reference reads XLA's ``cost_analysis`` and
``memory_analysis`` of a compiled program: on a mesh, one rank's local
shards, as the reference's partitioned program is one chip's.

The reference's ``collective_bytes`` parses the collectives out of XLA's
optimized HLO. The port's mesh program issues them as functional
collectives below DTensor, and ``CollectiveCounter`` records each one
that runs: its kind in the reference's names, its bytes per chip under the
reference's convention (the result's bytes; an all-reduce twice, for its
reduce-scatter and all-gather phases) and the mesh dims its group spans.
DTensor's Shard -> Shard regroup (MoE's expert-parallel exchange among
them) is one all-to-all of the local shard on every mesh a trace runs on
(``alltoalls_as_ops``).
A one-card trace has none: ``analyze`` gives ``collectives={}`` and its
``notes`` say why.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16

ONE_CARD_NOTE = "one card: no collective (the port runs none and emits no HLO)"
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# functional collective (``_c10d_functional``, or the legacy ``c10d_functional``)
# -> the reference's kind
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "isend": "collective-permute", "irecv": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # ``_dtensor``: a Shard -> Shard regroup
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


@dataclass(frozen=True)
class Collective:
    """A collective a mesh program ran (``n`` of them, when summed or
    fitted over depth): the reference's kind, the mesh dims its group
    spans, and its bytes per chip."""

    kind: str
    axes: Tuple[str, ...]
    bytes: int
    n: int = 1


def _nbytes(out) -> int:
    ts = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Records every functional collective that runs while it is entered,
    below DTensor (a DTensor op is handed back to DTensor, whose own
    collectives then come through here). ``device_mesh`` is the root mesh
    whose dims name a group's span: a group's ranks (``get_process_group_ranks``
    of its name) lie along the mesh dims on which their coordinates differ."""

    def __init__(self, device_mesh):
        super().__init__()
        self.records: List[Collective] = []
        self.names = tuple(device_mesh.mesh_dim_names)
        ranks = device_mesh.mesh.reshape(-1).tolist()
        self.coord = {r: tuple(int(i) for i in torch.unravel_index(torch.tensor(k),
                                                                     tuple(device_mesh.shape)))
                      for k, r in enumerate(ranks)}
        self._axes: Dict[str, Tuple[str, ...]] = {}

    def axes_of(self, group_name: str) -> Tuple[str, ...]:
        if group_name not in self._axes:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            coords = [self.coord[r] for r in
                      dist.get_process_group_ranks(_resolve_process_group(group_name))]
            self._axes[group_name] = tuple(
                n for i, n in enumerate(self.names) if len({c[i] for c in coords}) > 1)
        return self._axes[group_name]

    def record(self, func, args, kwargs, out) -> None:
        """Append ``func``'s record if it is a functional collective."""
        kind = _KIND_OF.get(func._opname) if func.namespace in _NAMESPACES else None
        if kind is not None:
            group = [a for a in (*args, *kwargs.values()) if isinstance(a, str)][-1]
            b = _nbytes(out)
            self.records.append(Collective(kind, self.axes_of(group),
                                           2 * b if kind == "all-reduce" else b))

    def __enter__(self):
        self._alltoalls = alltoalls_as_ops()
        self._alltoalls.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._alltoalls.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out


@contextmanager
def alltoalls_as_ops():
    """DTensor's Shard -> Shard regroup on ``meta`` shards runs as the
    all-to-all op (``_dtensor.shard_dim_alltoall``, whose fake kernel gives
    its result's shape) on every mesh, as it does on a CUDA mesh. On a CPU
    mesh DTensor would gather the whole tensor and keep a chunk (gloo has no
    all-to-all), and a mesh trace, which moves no data, would count that
    gather: group-size times the all-to-all's bytes. A regroup of real
    shards on a CPU mesh still gathers, and is counted as what it runs."""
    import torch.distributed.tensor.placement_types as PT

    plain = PT.shard_dim_alltoall  # DTensor's regroup calls it by this name

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return plain(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = plain


def collective_bytes(records: List[Collective]) -> Dict[str, int]:
    """Bytes per chip by the reference's kinds (its ``collective_bytes``)."""
    out = {k: 0 for k in KINDS}
    for c in records:
        out[c.kind] += c.bytes
    return out


def summed(records: List[Collective]) -> List[Collective]:
    """One record a (kind, axes), its ``n`` and bytes summed."""
    n, b = Counter(), Counter()
    for c in records:
        n[c.kind, c.axes] += c.n
        b[c.kind, c.axes] += c.bytes
    return [Collective(k, a, b[k, a], n[k, a]) for k, a in sorted(n)]


def collective_table(records: List[Collective]) -> Dict[str, Dict[str, int]]:
    """``{"<kind> over <axes>": {"n": collectives, "bytes": per chip}}``."""
    return {f"{c.kind} over {'+'.join(c.axes) or 'none'}": {"n": c.n, "bytes": c.bytes}
            for c in summed(records)}


def cross_pod(records: List[Collective], axis: str = "pod") -> Tuple[int, int]:
    """(collectives, bytes per chip) of the records whose group spans ``axis``."""
    hit = [c for c in records if axis in c.axes]
    return sum(c.n for c in hit), sum(c.bytes for c in hit)


@dataclass
class TraceCost:
    """What one traced run of a step executed: the products' FLOPs, the
    bytes its operations read and wrote, its arguments' and new outputs'
    bytes, the peak of the storages it allocated that were live at once,
    its ops and its hand-written kernels' calls."""

    flops: float
    bytes_accessed: float
    arg_bytes: int
    out_bytes: int
    peak_bytes: int
    n_ops: int = 0
    kernel_calls: int = 0  # hand-written kernels counted as the card runs them
    collectives: Optional[List[Collective]] = None  # a mesh program's; None on one card


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    mode: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: Dict[str, int]
    arg_bytes: int
    temp_bytes: int
    out_bytes: int
    model_flops: float = 0.0
    notes: str = ""
    peak_bytes: int = 0
    collective_table: Dict[str, Dict[str, int]] = field(default_factory=dict)
    cross_pod_collectives: int = 0
    cross_pod_bytes_per_chip: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def fits_one_card(self) -> bool:
        """The arguments and the step's peak of live allocations within the
        card's 80 GB."""
        return self.arg_bytes + self.peak_bytes <= HBM_BYTES

    def row(self) -> Dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio, fits_one_card=self.fits_one_card)
        return d


def analyze(cost: TraceCost, *, arch: str, shape: str, mesh_name: str = "1", mode: str,
            chips: int = 1, model_flops: float = 0.0, notes: str = "") -> Roofline:
    """A ``Roofline`` from one traced run's counts (one chip's, on a mesh).
    ``temp_bytes`` is the part of the peak beyond the step's new outputs
    (XLA's temp size's counterpart). A one-card trace has no collective."""
    recs = cost.collectives
    if recs is None:
        colls, table, xpod, note = {}, {}, (0, 0), ONE_CARD_NOTE
    else:
        colls, table, xpod, note = (collective_bytes(recs), collective_table(recs),
                                    cross_pod(recs), "")
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, mode=mode, chips=chips,
        flops_per_chip=float(cost.flops), bytes_per_chip=float(cost.bytes_accessed),
        collective_bytes_per_chip=float(sum(colls.values())), collectives=colls,
        arg_bytes=int(cost.arg_bytes), temp_bytes=max(int(cost.peak_bytes - cost.out_bytes), 0),
        out_bytes=int(cost.out_bytes), model_flops=model_flops,
        notes="; ".join(n for n in (note, notes) if n),
        peak_bytes=int(cost.peak_bytes), collective_table=table,
        cross_pod_collectives=xpod[0], cross_pod_bytes_per_chip=float(xpod[1]))


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D with N = active params (MoE: non-expert + top_k/E of experts),
    for every family as the reference counts it (whisper's encoder and
    decoder parameters together). Decode shapes: D = global_batch tokens
    (one step); others global_batch * seq_len; 2*N*D outside training."""
    from repro_torch.roofline.params import active_param_count

    n_active = active_param_count(cfg)
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
