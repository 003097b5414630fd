"""The dry run: trace every (arch x input shape) step at full width on
fake tensors, on the reference's production meshes or on one card, count
what it executes, and set the counts against the H100's data-sheet
roofline (the counterpart of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k \
        --mode shadow --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k \
        --sync-algo easgd --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --one-card --all --out results/dryrun.json

The reference lowers and compiles each program on 256 or 512 forced host
devices and reads XLA's ``cost_analysis`` and ``memory_analysis`` of the
partitioned program: one chip's. The port runs its mesh program on a fake
process group of 256 or 512 ranks in one process (``launch/mesh.py::
fake_world``), the (16, 16) "data" x "model" mesh or the (2, 16, 16) one
with "pod" in front, on DTensors over ``meta`` local shards
(``launch/specs.py``), and traces rank 0's program once (``_trace_cost``).
Its counters sit below DTensor, so they see what one chip runs: the
products on local shards, the local bytes, and each collective DTensor
issues (``roofline/analysis.py::CollectiveCounter``: its kind, its bytes per
chip, the mesh dims its group spans). ``--one-card`` traces the one-card
program instead (the card the port computes on: no collective), the form
``chip_smoke.py``'s roofline check holds the card's times against.

What a trace counts:

- FLOPs: the products' (matmuls, ``bmm``, einsum's products; no
  elementwise op);
- bytes: each operation's input and output bytes (``_ByteCounter``). A
  view, reshape, detach or other metadata op counts 0, an in-place op its
  operands once, a broadcast input its distinct elements. Eager PyTorch
  fuses nothing, so this is the traffic the card really moves, up to what
  its caches catch;
- peak bytes: the most storage the step's own allocations held live at
  once; the arguments' and the new outputs' bytes beside it;
- collectives (on a mesh): by kind, by the mesh dims they span, and those
  that cross the pods.

Where the card launches K9 (every unwindowed self-attention of a prefill;
on a mesh, each rank's own rows and heads), the wrapper counts K9's work
(``backend.tracing``): the causal pairs' products, q, k and v read once
and the output written once. The plain version's f32 S x S score passes,
which the reference's prefill runs and XLA fuses, would be counted in full
and never run on the card: counted so, llava-next-34b's prefill of 4 x
3,136 positions got a 1,725 ms bound, above the 1,602 ms it takes on an
H100 80GB HBM3 (700 W). The training form's attention is counted as the
card runs it too: bf16 self-attention at head dim 64 or 128 without a
window as the training kernels (``attention_train_op``: the forward's two
products over the causal pairs, the backward's five, each pass's operands
once), everything else (f32 models, windows, cross-attention) as its
plain path, with every rematerialised forward the backward pass runs
(the unit remat's recompute of the kernels' forward among them). A
Python loop runs every layer, so a trace counts the
whole depth (XLA counts a scan body once, which is why the reference fits
its costs over depth); a full-depth training trace of the largest archs
takes minutes, though, so ``run_one`` fits a training step's counts over
depth from two shallow traces (``extrapolate_cost``) on one card and on the
single-pod mesh, as the reference fits only there; the multi-pod mesh,
prefill and decode are traced in full.

The row is the reference's (``chips`` the mesh's size, or 1 on one card)
plus ``peak_bytes``, ``fits_one_card`` (arguments + peak within 80 GB),
the collectives by kind and span (``collective_table``), the cross-pod
collectives and bytes, and ``placed_param_bytes``: one copy of the
parameters as a chip of the mesh (the reference's 16 x 16 one on one
card) holds it under ``sharding/rules.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import optim
from repro_torch import tree as T
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import spmd
from repro_torch.core.sync import SyncConfig
from repro_torch.kernels import backend
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (Mesh, describe, device_mesh, fake_world,
                                     make_production_mesh)
from repro_torch.roofline import analysis as RA
from repro_torch.sharding import ctx as shctx

# Archs whose serve step at 500k context is sub-quadratic (DESIGN.md §4).
LONG_CONTEXT_OK = {"mamba2-780m", "jamba-1.5-large-398b", "phi3-medium-14b"}
ONE_CARD = Mesh(("data", "model"), (1, 1))  # the card the port computes on
PLACEMENT = make_production_mesh()  # the reference's single pod, (data 16, model 16)

aten = torch.ops.aten
# ops that allocate or relabel storage without moving data
_NO_DATA_OPS = {aten.detach.default, aten.alias.default, aten._unsafe_view.default,
                aten.lift_fresh.default, aten.empty.memory_format, aten.empty_strided.default,
                aten.empty_like.default, aten.new_empty.default, aten.new_empty_strided.default,
                aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
                aten.sym_storage_offset.default, aten.is_same_size.default}


def resolve_config(arch: str, shape_name: str):
    if arch == "phi3-medium-14b" and shape_name == "long_500k":
        from repro_torch.configs.phi3_medium_14b import CONFIG_SWA

        return CONFIG_SWA  # sliding-window variant (DESIGN.md §4)
    return get_config(arch)


def should_skip(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "full-attention arch: 500k dense KV decode is quadratic-cost (skip per DESIGN.md)"
    return None


class Program(NamedTuple):
    """A step, its fake arguments and their specs; on a device mesh, the
    batch axes of the activation context it runs under."""

    step: Callable
    args: tuple
    specs: tuple
    batch_axes: tuple = ("data",)


def build(cfg, shape_name: str, mesh, *, mode: str = "syncdp", optimizer: str = "adagrad",
          n_replicas: int = 2, n_microbatches: int = 8, shape_override=None, fsdp: bool = True,
          grad_dtype: str = "float32", remat_policy: str = "full") -> Program:
    """The step of ``shape_name``'s kind (train, prefill or decode) for
    ``cfg``, on fake structures. ``fsdp``, ``grad_dtype``,
    ``n_microbatches`` and ``remat_policy`` are the reference's §Perf
    knobs; ``fsdp`` moves only the specs. ``mesh`` a ``Mesh`` (the
    one-card program on fake global structures) or a ``DeviceMesh`` (the
    mesh program on DTensors)."""
    shape = shape_override or INPUT_SHAPES[shape_name]
    fake = FakeTensorMode()
    if shape.kind == "train":
        opt = optim.make(optimizer, 1e-3)
        params = SP.param_structs(cfg, mesh, mode=mode, n_replicas=n_replicas, fsdp=fsdp,
                                  fake=fake)
        opt_state = SP.opt_structs(opt, params[0], mesh, fsdp=fsdp, fake=fake,
                                   replica_axis="pod" if mode == "shadow" else None)
        batch = SP.train_batch_structs(cfg, shape, mesh, mode=mode, n_replicas=n_replicas,
                                       fake=fake)
        step = spmd.make_train_step(cfg, opt, mode, n_microbatches=n_microbatches,
                                    grad_dtype=grad_dtype, remat_policy=remat_policy)
        parts = (params, opt_state, batch)
    elif shape.kind == "prefill":
        parts = (SP.param_structs(cfg, mesh, mode="syncdp", fsdp=fsdp, fake=fake),
                 SP.train_batch_structs(cfg, shape, mesh, mode="syncdp", fake=fake))
        step = spmd.make_prefill_step(cfg, shape.seq_len)
    else:
        params = SP.param_structs(cfg, mesh, mode="syncdp", fsdp=fsdp, fake=fake)
        cache = SP.cache_structs(cfg, shape.global_batch, shape.seq_len, mesh, fake=fake)
        db = SP.decode_batch_structs(cfg, shape, mesh, fake=fake)
        parts = (params, cache, (db[0]["token"], db[1]["token"]), (db[0]["pos"], db[1]["pos"]))
        step = spmd.make_decode_step(cfg)
    mode = mode if shape.kind == "train" else "syncdp"
    return Program(step, tuple(p[0] for p in parts), tuple(p[1] for p in parts),
                   SP.batch_axes(mesh, mode))


def build_sync_step(arch: str, mesh, *, algo: str = "easgd", n_replicas: int = 2,
                    cfg=None) -> Program:
    """The background program (ShadowSync's own): ``sync_step(params_stack,
    algo_state)``, uniform across the algorithm registry. ``cfg`` overrides
    ``arch``'s config (a cut depth)."""
    cfg = cfg or get_config(arch)
    sync_cfg = SyncConfig(algo=algo).validate()
    fake = FakeTensorMode()
    params = SP.param_structs(cfg, mesh, mode="shadow", n_replicas=n_replicas, fake=fake)
    single = SP.param_structs(cfg, mesh, mode="syncdp", fake=fake)
    state = SP.sync_state_structs(sync_cfg, single[0], mesh, fake=fake)
    return Program(spmd.make_sync_step(cfg, sync_cfg), (params[0], state[0]),
                   (params[1], state[1]), SP.batch_axes(mesh, "shadow"))


def placed_param_bytes(cfg, *, fsdp: bool = True, mesh: Mesh = PLACEMENT) -> int:
    """The bytes of one copy of ``cfg``'s parameters that each chip of
    ``mesh`` holds under ``sharding/rules.py``'s specs, with the FSDP axis
    or without (``--no-fsdp``)."""
    structs, specs = SP.param_structs(cfg, mesh, fsdp=fsdp)

    def shard(t, spec):
        n = t.numel()
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n //= mesh.shape[a]  # the rules place an axis only where it divides
        return n * t.element_size()

    return sum(T.leaves(T.map(shard, structs, specs)))


def _tensors(tree) -> list:
    """The tensors of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    return [t._local_tensor if isinstance(t, DTensor) else t for t in T.leaves(tree)
            if isinstance(t, torch.Tensor)]


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` addresses: a broadcast (stride 0)
    dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _ByteCounter(TorchDispatchMode):
    """Counts each op's bytes moved, and the live storages the ops allocate.

    A storage is live while anything but this counter holds it: the
    counter keeps a reference to every storage it saw made and reads the
    use count (``torch._C._storage_Use_Count``); a storage only it holds is
    dead. ``cur`` may count dead storages until the next sweep, which runs
    whenever it would raise the peak, so the peak is exact.

    With ``collectives`` (a ``CollectiveCounter`` of the mesh's) it counts
    one rank of a mesh program: it hands each DTensor op back to DTensor and
    counts the local ops DTensor runs, their products' FLOPs too (``flops``,
    from ``torch.utils.flop_counter``'s formulas, as ``FlopCounterMode``
    counts a plain trace), records their collectives, and skips the ops
    DTensor runs on fake tensors to propagate its shardings."""

    def __init__(self, arg_keys, collectives: Optional[RA.CollectiveCounter] = None):
        super().__init__()
        self.arg_keys = set(arg_keys)
        self.bytes = 0
        self.n_ops = 0
        self.held: Dict[int, tuple] = {}
        self.cur = 0
        self.peak = 0
        self.collectives = collectives
        self.flops = 0

    def _sweep(self):
        for k in [k for k in self.held if torch._C._storage_Use_Count(k) <= 1]:
            self.cur -= self.held.pop(k)[1]

    def _track(self, t: torch.Tensor):
        k = _key(t)
        if k in self.held or k in self.arg_keys:
            return
        st = t.untyped_storage()
        self.held[k] = (st, st.nbytes())
        self.cur += st.nbytes()
        if self.cur > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.collectives is not None:
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
                return func(*args, **kwargs)  # DTensor's sharding propagation
        out = func(*args, **kwargs)
        if func.namespace == "prim":  # metadata queries (prim.device)
            return out
        self.n_ops += 1
        if self.collectives is not None:
            self.collectives.record(func, args, kwargs, out)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not (func.is_view or func in _NO_DATA_OPS):
            seen, ins = set(), []
            for t in _tensors((args, kwargs)):
                if id(t) not in seen:
                    seen.add(id(t))
                    ins.append(t)
            moved = sum(_distinct_bytes(t) for t in ins)
            in_keys = {_key(t) for t in ins}
            # an in-place (or out=) op's result is an operand, counted once
            moved += sum(_distinct_bytes(t) for t in outs if _key(t) not in in_keys)
            self.bytes += moved
        for t in outs:
            self._track(t)
        return out


def _meta_twin(tree):
    """Each tensor of ``tree`` as a ``meta`` tensor of the same shape,
    strides and dtype (other leaves, and DTensors, whose local shards are
    ``meta`` already, as they are)."""
    from torch.distributed.tensor import DTensor

    return T.map(lambda x: torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
                 if isinstance(x, torch.Tensor) and not isinstance(x, DTensor) else x, tree)


def _storage_bytes(tensors, skip=()) -> Dict[int, int]:
    out = {}
    for t in tensors:
        if _key(t) not in skip:
            out.setdefault(_key(t), t.untyped_storage().nbytes())
    return out


def _mesh_of(args):
    """The root device mesh of a program's DTensor arguments, or None."""
    from torch.distributed.tensor import DTensor

    for t in T.leaves(args):
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def _trace_cost(program: Program) -> RA.TraceCost:
    """Run ``program.step`` once under ``FlopCounterMode``,
    ``_ByteCounter`` and ``backend.tracing``, on ``meta`` twins of its fake
    arguments: the same shapes, strides and dtypes. Nothing is allocated.
    On meta tensors the ops run their meta kernels directly (the fake
    mode's own dispatch would take twice the rest of a trace), and autograd
    makes the copies it makes on real tensors (an in-place op on a view
    gets a ``new_zeros`` and a ``copy_`` in the backward pass, which a fake
    trace skips): ``tests/test_torch_dryrun.py`` holds the counts to a run
    on real tensors. DTensor arguments (a mesh program) run under their
    mesh's activation context and are counted below DTensor, one rank's
    local ops and collectives (``_ByteCounter``'s mesh form)."""
    args = _meta_twin(program.args)
    arg_store = _storage_bytes(_tensors(args))
    dm = _mesh_of(args)
    if dm is None:
        counter = _ByteCounter(arg_store)
        flops = FlopCounterMode(display=False)
        with backend.tracing() as kernels, flops, counter:
            out = program.step(*args)
        products, records = flops.get_total_flops(), None
    else:
        counter = _ByteCounter(arg_store, RA.CollectiveCounter(dm))
        with shctx.activation_mesh(dm, batch_axes=program.batch_axes), \
                RA.alltoalls_as_ops(), backend.tracing() as kernels, counter:
            out = program.step(*args)
        products, records = counter.flops, counter.collectives.records
    out_store = _storage_bytes(_tensors(out), skip=arg_store)
    counter._sweep()
    work = [sum(w[i] for w in kernels.work.values()) for i in range(3)]
    return RA.TraceCost(flops=float(products + work[1]),
                        bytes_accessed=float(counter.bytes + work[2]),
                        arg_bytes=sum(arg_store.values()), out_bytes=sum(out_store.values()),
                        peak_bytes=counter.peak, n_ops=counter.n_ops, kernel_calls=work[0],
                        collectives=records)


def _depth_variant(cfg, n_units: int):
    """The same arch with ``n_units`` repeats of its unit (and as many
    encoder layers)."""
    upd = {"n_layers": len(cfg.layer_pattern) * n_units}
    if cfg.encoder is not None:
        upd["encoder"] = dataclasses.replace(cfg.encoder, n_layers=n_units)
    return dataclasses.replace(cfg, **upd)


FIT_UNITS = (2, 3)  # the depth fit's probes, in units


def extrapolate_cost(cfg, shape_name: str, mesh, **build_kw) -> RA.TraceCost:
    """The full-depth counts of ``build(cfg, ...)`` fitted from two shallow
    traces, cost = a + b * units, with probes at 2 and 3 units. A Python
    loop traces every layer, but a full-depth training trace of the
    largest archs takes minutes (granite-20b at train_4k, 52 layers x 8
    microbatches: 197 s on 8 CPU cores under the fake mode, about a third
    of it on meta twins; jamba's 72 layers longer). FLOPs, bytes, ops and
    the outputs grow by the same amount with each unit, so their fit is
    exact (``tests/test_torch_dryrun.py``). The peak is the largest of
    the step's phases, each linear in depth; the fit is exact while one
    phase holds it at both probes and at full depth, as the activations
    and gradients do at the reference's training shapes (held there by a
    test), but where they are small a phase of the optimizer's update can
    take over between the probes and full depth; a largest of linear
    terms is convex, so the fit is then below the true peak, never above,
    and it is never taken below either probe's own peak.
    The arguments' bytes
    come from the full-depth structures, built without a trace."""
    repeats = cfg.n_layers // len(cfg.layer_pattern)
    full = build(cfg, shape_name, mesh, **build_kw)
    if repeats <= FIT_UNITS[-1]:
        return _trace_cost(full)
    lo, hi = (_trace_cost(build(_depth_variant(cfg, n), shape_name, mesh, **build_kw))
              for n in FIT_UNITS)
    span = FIT_UNITS[1] - FIT_UNITS[0]

    def fit(a, b):
        return a + (b - a) * (repeats - FIT_UNITS[0]) // span

    colls = None
    if lo.collectives is not None:  # each (kind, span)'s count and bytes, fitted
        los = {(c.kind, c.axes): c for c in RA.summed(lo.collectives)}
        his = {(c.kind, c.axes): c for c in RA.summed(hi.collectives)}
        zero = RA.Collective("", (), 0, 0)
        colls = [RA.Collective(k[0], k[1], fit(los.get(k, zero).bytes, his.get(k, zero).bytes),
                               fit(los.get(k, zero).n, his.get(k, zero).n))
                 for k in sorted(set(los) | set(his))]
    return RA.TraceCost(
        flops=float(fit(int(lo.flops), int(hi.flops))),
        bytes_accessed=float(fit(int(lo.bytes_accessed), int(hi.bytes_accessed))),
        arg_bytes=sum(_storage_bytes(_tensors(full.args)).values()),
        out_bytes=fit(lo.out_bytes, hi.out_bytes),
        peak_bytes=max(fit(lo.peak_bytes, hi.peak_bytes), lo.peak_bytes, hi.peak_bytes),
        n_ops=fit(lo.n_ops, hi.n_ops), kernel_calls=fit(lo.kernel_calls, hi.kernel_calls),
        collectives=colls)


def mesh_for(multi_pod: bool = False, one_card: bool = False):
    """(mesh, its name, chips): the reference's production mesh as a
    ``DeviceMesh`` over a fake world of its size, or the one card's
    description."""
    if one_card:
        return ONE_CARD, "1", 1
    mesh = make_production_mesh(multi_pod=multi_pod)
    fake_world(mesh.size)
    return device_mesh(mesh), "x".join(map(str, mesh.axis_sizes)), mesh.size


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False, one_card: bool = False,
            mode: str = "syncdp", optimizer: str = "adagrad", verbose: bool = True,
            sync_algo: Optional[str] = None, fsdp: bool = True, grad_dtype: str = "float32",
            n_microbatches: int = 8, capacity_factor: Optional[float] = None,
            parallel_block: bool = False, remat_policy: str = "full") -> Dict[str, Any]:
    """One (arch x shape) row: ``status`` ok (the roofline's row), skipped
    (the reference's skips) or fail (the error). On the single-pod (16, 16)
    mesh by default, the multi-pod (2, 16, 16) one with ``multi_pod``, one
    card with ``one_card``."""
    mesh_name = "1" if one_card else ("2x16x16" if multi_pod else "16x16")
    skip = should_skip(arch, shape_name)
    tag = f"{arch} x {shape_name} x {mesh_name} [{sync_algo or mode}]"
    if skip:
        if verbose:
            print(f"SKIP  {tag}: {skip}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "mode": mode,
                "status": "skipped", "reason": skip}
    t0 = time.time()
    try:
        mesh, mesh_name, chips = mesh_for(multi_pod, one_card)
        cfg = resolve_config(arch, shape_name)
        if capacity_factor is not None and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        if parallel_block:
            cfg = dataclasses.replace(cfg, parallel_block=True)
        kw = dict(mode=mode, optimizer=optimizer, fsdp=fsdp, grad_dtype=grad_dtype,
                  n_microbatches=n_microbatches, remat_policy=remat_policy)
        # the fit over depth: one card and the single-pod mesh, as the
        # reference fits only there
        fitted = not sync_algo and INPUT_SHAPES[shape_name].kind == "train" \
            and not multi_pod and cfg.n_layers // len(cfg.layer_pattern) > FIT_UNITS[-1]
        if sync_algo:
            cost = _trace_cost(build_sync_step(arch, mesh, algo=sync_algo, cfg=cfg))
        elif fitted:
            cost = extrapolate_cost(cfg, shape_name, mesh, **kw)
        else:
            cost = _trace_cost(build(cfg, shape_name, mesh, **kw))
        mf = RA.model_flops_estimate(cfg, INPUT_SHAPES[shape_name]) if not sync_algo else 0.0
        how = (f"depth-fitted from {FIT_UNITS[0]}- and {FIT_UNITS[1]}-unit traces" if fitted
               else "traced at full depth")
        r = RA.analyze(cost, arch=arch, shape=shape_name, mesh_name=mesh_name,
                       mode=f"sync:{sync_algo}" if sync_algo else mode, chips=chips,
                       model_flops=mf, notes=f"{cost.n_ops} ops {how}")
        row = r.row()
        row.update(status="ok", trace_s=round(time.time() - t0, 1))
        placement = PLACEMENT if one_card else describe(mesh)
        row["placed_param_bytes"] = placed = placed_param_bytes(cfg, fsdp=fsdp, mesh=placement)
        if verbose:
            gib, mib = 2 ** 30, 2 ** 20
            where = "card" if one_card else "chip"
            print(f"OK    {tag}  trace={row['trace_s']}s chips={chips}")
            print(f"      mem/{where}: args={r.arg_bytes / gib:.2f}GiB "
                  f"temp={r.temp_bytes / gib:.2f}GiB "
                  f"out={r.out_bytes / gib:.2f}GiB peak={r.peak_bytes / gib:.2f}GiB "
                  f"fits_one_card={r.fits_one_card}")
            print(f"      params placed on {'the reference' if one_card else 'this'}'s "
                  f"{'x'.join(map(str, placement.axis_sizes))} mesh "
                  f"({'fsdp' if fsdp else 'no fsdp'}): {placed / gib:.2f}GiB/chip")
            print(f"      roofline: t_comp={r.t_compute * 1e3:.2f}ms "
                  f"t_mem={r.t_memory * 1e3:.2f}ms t_coll={r.t_collective * 1e3:.2f}ms "
                  f"-> {r.bottleneck}-bound; useful_flops={r.useful_flops_ratio:.2f}")
            if one_card:
                print(f"      collectives: {{}} ({RA.ONE_CARD_NOTE})")
            else:
                print(f"      collectives: "
                      f"{ {k: f'{v / mib:.1f}MiB' for k, v in r.collectives.items() if v} }")
                print(f"      cross-pod: {r.cross_pod_collectives} collectives, "
                      f"{r.cross_pod_bytes_per_chip / mib:.1f}MiB/chip")
        return row
    except Exception as e:
        if verbose:
            print(f"FAIL  {tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "mode": mode,
                "status": "fail", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod x data x model mesh (512 chips)")
    ap.add_argument("--both-meshes", action="store_true", help="the 16x16 mesh, then 2x16x16")
    ap.add_argument("--one-card", action="store_true",
                    help="the one-card program (no mesh, no collective)")
    ap.add_argument("--mode", choices=["syncdp", "shadow"], default="syncdp")
    ap.add_argument("--sync-algo", choices=["easgd", "ma", "bmuf"], default=None,
                    help="trace the background sync_step instead of train/serve")
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    # the reference's §Perf knobs
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--grad-dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--parallel-block", action="store_true")
    ap.add_argument("--remat-policy", choices=["full", "save_comm"], default="full")
    args = ap.parse_args(argv)
    if args.one_card and (args.multi_pod or args.both_meshes):
        ap.error("--one-card traces no mesh: drop --multi-pod and --both-meshes")

    rows = []
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False] if args.one_card else \
        [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    def write():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rows.append(run_one(arch, shape, multi_pod=mp, one_card=args.one_card,
                                    mode=args.mode, optimizer=args.optimizer,
                                    sync_algo=args.sync_algo, fsdp=not args.no_fsdp,
                                    grad_dtype=args.grad_dtype,
                                    n_microbatches=args.microbatches,
                                    capacity_factor=args.capacity_factor,
                                    parallel_block=args.parallel_block,
                                    remat_policy=args.remat_policy))
                if args.out:  # incremental: survives an interruption
                    write()
    if args.out:
        write()
        print(f"wrote {len(rows)} rows to {args.out}")
    n_ok = sum(r.get("status") == "ok" for r in rows)
    n_skip = sum(r.get("status") == "skipped" for r in rows)
    n_fail = sum(r.get("status") == "fail" for r in rows)
    print(f"\nSummary: {n_ok} ok, {n_skip} skipped, {n_fail} failed / {len(rows)}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
