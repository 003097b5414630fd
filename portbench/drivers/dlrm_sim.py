"""Driver of ``HogwildSim`` (``repro_torch/core/runners.py``): R trainers x M
Hogwild threads x B examples a thread, one packed embedding table, shadow
sync through the flat engine.

Set-up builds the sim, hands it the benchmark's tables and weights
(``_state_from``) and its batch stream (the ``make_batch`` hook, drawn on
the card from the seed), and drives the first three iterations through
``run`` (one, then two), reading the first gradient from the optimizer's
accumulators after the first and each leaf's change after the third. A
warm-up ``run`` gives the pace; the window is ONE ``run`` call of as many
iterations as fill ``seconds`` at that pace, its iterations timed by the
``on_iter`` callback. A traced run (``--trace 1``) follows the window. The
program's state is freed before the reference follows the first three
iterations.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List

import torch

from portbench.reference import compare, data, dlrm_ref, trace, work

KERNEL_SOURCES = ("embedding_bag", "sparse_adagrad", "easgd_update")  # K1, K2, K3
CHECK_STEPS = (1, 2)  # the first iterations, as ``run`` calls
WARM_ITERS = 10
TRACE_ITERS = 20


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def program_config(cfg: dict):
    from repro_torch.configs import dlrm_ctr

    fields = {f.name for f in dataclasses.fields(dlrm_ctr.DLRMConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    return dataclasses.replace(dlrm_ctr.CONFIG, **kw)


def shadow_landings(R: int, gap: int, delay: int, n_iters: int) -> List[int]:
    """The fired replicas of each landing of one ``run`` of ``n_iters``
    iterations (the launch in flight at its start and end dropped): the
    shadow clocks as ``dlrm_ref`` states them."""
    offs = [i * gap // R for i in range(R)]
    out, pending = [], None
    for t in range(n_iters):
        if pending is not None and t + 1 >= pending[0]:
            out.append(pending[1])
            pending = None
        fired = sum((t + 1 + o) % gap == 0 for o in offs)
        if pending is None and fired:
            if delay == 0:
                out.append(fired)
            else:
                pending = (t + 1 + delay, fired)
    return out


def run(cell) -> dict:
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import backend

    cfg, mix, seed, dev = cell.config, cell.mix, cell.seed, torch.device(cell.device)
    R, M, B = mix["trainers"], mix["threads"], mix["batch_per_thread"]
    F, m = cfg["n_sparse_features"], cfg["multi_hot"]
    n = R * M * B
    marks = {"driver": time.perf_counter() - cell.t0}
    if dev.type == "cuda":
        backend.build(KERNEL_SOURCES)
    marks["kernels"] = time.perf_counter() - cell.t0
    sync_cfg = SyncConfig(algo=mix["algo"], mode=mix["mode"], gap=mix["sync_gap"],
                          alpha=mix["alpha"], delay=mix["sync_delay"], engine="flat")
    sim = HogwildSim(program_config(cfg), sync_cfg, n_trainers=R, n_threads=M, batch_size=B,
                     optimizer=optim.make(mix["optimizer"], mix["lr"]), emb_lr=mix["emb_lr"],
                     device=str(dev))
    marks["sim"] = time.perf_counter() - cell.t0
    teacher = data.make_teacher(cfg, seed, dev)

    def make_batch(it: int) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function(trace.HARNESS):  # the draw is the harness's
            b = data.ctr_batch(cfg, teacher, seed, it, n)
            return {k: v.reshape(R, M, B, *v.shape[1:]) for k, v in b.items()}

    sim.make_batch = make_batch
    offsets = torch.as_tensor(data.offsets(cfg), device=dev)[None, :, None]

    def rows_of(it: int) -> torch.Tensor:
        return (make_batch(it)["sparse"].reshape(-1, F, m) + offsets).reshape(-1).long()

    w0 = data.dlrm_dense(cfg, seed, dev)
    table = data.dlrm_table(cfg, seed, dev)
    st = sim._state_from(w0, {"table": table, "acc": torch.zeros_like(table)})
    del table
    touched = torch.unique(torch.cat([rows_of(t) for t in range(sum(CHECK_STEPS))]))
    rows0 = st.emb_state["table"][touched].clone()

    # the checked iterations, through the window's own call
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for k, steps in enumerate(CHECK_STEPS):
        losses += sim.run(steps, state=st)["train_loss"]
        if k == 0:
            for path, acc in T.leaves_with_path(st.opt_stack):
                for r in range(R):
                    grad[f"r{r}/{path}"] = math.sqrt(float(acc[r].sum()))
            grad["table"] = math.sqrt(float(st.emb_state["acc"].sum()))
    change: Dict[str, float] = {}
    was = dict(T.leaves_with_path(w0))
    for path, w in T.leaves_with_path(sim.dense_stack(st)):
        for r in range(R):
            change[f"r{r}/{path}"] = float((w[r] - was[path]).norm())
    for path, w in T.leaves_with_path(sim.flat.unpack(st.algo_state)):
        change[f"ps/{path}"] = float((w - was[path]).norm())
    change["table"] = float((st.emb_state["table"][touched] - rows0).norm())
    prog = {"losses": losses, "grad": grad, "change": change}
    del rows0, touched
    marks["checked"] = time.perf_counter() - cell.t0

    # warm-up: the pace of a run
    _sync(dev)
    t0 = time.perf_counter()
    sim.run(WARM_ITERS, state=st)
    _sync(dev)
    pace = (time.perf_counter() - t0) / WARM_ITERS
    n_iters = max(1, round(cell.seconds / pace))

    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    stamps: List[float] = []
    _sync(dev)
    start = time.perf_counter()
    out = sim.run(n_iters, state=st, on_iter=lambda t, loss: stamps.append(time.perf_counter()))
    _sync(dev)
    end = time.perf_counter()
    iter_s = [b - a for a, b in zip([start] + stamps[:-1], stamps)]
    rec = {"setup_s": start - cell.t0, "window_s": end - start, "iters": n_iters,
           "iter_s": iter_s, "examples": out["examples"],
           "flops_per_iter": work.dlrm_flops_per_example(cfg) * n,
           "attempted": n_iters,
           "failed": sum(not math.isfinite(x) for x in out["train_loss"])}
    del out
    if cell.trace and dev.type == "cuda":
        # the run's result holds the state: keep none of it
        summ, rec["trace_wall_s"] = trace.traced(torch, lambda: sim.run(TRACE_ITERS, state=st))[1:]
        rec["trace"] = summ
        if summ is not None:
            d = cfg["embedding_dim"]
            k1, k2 = {"bytes": 0.0, "flops": 0.0}, {"bytes": 0.0, "flops": 0.0}
            # a lost first attempt ran its iterations too: the kept body is the last
            for it in range(st.step - TRACE_ITERS, st.step):
                rows = rows_of(it)
                nu = int(torch.unique(rows).numel())
                for acc, fn in ((k1, work.k1_work), (k2, work.k2_work)):
                    for key, v in fn(n * F, n * F * m, nu, d).items():
                        acc[key] += v
            rec["work"] = {"k1": k1, "k2": k2}
            rec["trace_landings"] = len(shadow_landings(R, mix["sync_gap"], mix["sync_delay"],
                                                        TRACE_ITERS))
            rec["trace_iters"] = TRACE_ITERS
    t_trace = time.perf_counter()
    mem = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec["memory_peak_bytes"] = max(setup_peak, mem)
    del sim, st, teacher
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = dlrm_ref.run(cfg, mix, seed, dev, steps=sum(CHECK_STEPS),
                       boundaries=tuple(itertools.accumulate(CHECK_STEPS)))
    rec["phases_s"] = {"setup": start - cell.t0, "setup_marks": marks, "window": end - start,
                       "trace": t_trace - end, "reference": time.perf_counter() - t_trace}
    rec["checks"] = compare.checks(prog, ref, cell.limits)
    rec["worst"] = compare.where(prog, ref)
    return rec

