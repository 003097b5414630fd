"""Roofline terms of the one-card dry run, and model FLOPs (the twin of
``repro/roofline/analysis.py``).

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = bytes moved / HBM bandwidth
    collective term = collective bytes / link bandwidth

over the NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet constants of
``launch/mesh.py``. The counts come from ``launch/dryrun.py::_trace_cost``,
which runs the port's own step once on fake tensors and counts what that
program executes (``TraceCost``), where the reference reads XLA's
``cost_analysis`` and ``memory_analysis`` of a compiled program.

The reference's ``collective_bytes`` is not ported: it parses the
collectives out of XLA's optimized HLO text, and the port emits no HLO and
runs no collective (one process, one card). ``analyze`` gives
``collectives={}`` and ``collective_bytes_per_chip=0``, and its ``notes``
say why.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16

ONE_CARD_NOTE = "one card: no collective (the port runs none and emits no HLO)"


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
    """A ``Roofline`` from one traced run's counts. ``temp_bytes`` is the
    part of the peak beyond the step's new outputs (XLA's temp size's
    counterpart)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, mode=mode, chips=chips,
        flops_per_chip=float(cost.flops), bytes_per_chip=float(cost.bytes_accessed),
        collective_bytes_per_chip=0.0, collectives={},
        arg_bytes=int(cost.arg_bytes), temp_bytes=max(int(cost.peak_bytes - cost.out_bytes), 0),
        out_bytes=int(cost.out_bytes), model_flops=model_flops,
        notes=f"{ONE_CARD_NOTE}; {notes}" if notes else ONE_CARD_NOTE,
        peak_bytes=int(cost.peak_bytes))


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
