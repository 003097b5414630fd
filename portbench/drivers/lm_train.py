"""Driver of the LM trainer (``repro_torch/core/spmd.py``): R replicas in
shadow mode, ``make_train_step`` each iteration and ``make_sync_step``
after every ``sync_gap``-th, as ``launch/train.py lm`` drives them.

Set-up hands the program the benchmark's weights (drawn on the card from
the seed in the configuration's dtype) and a bank of token batches (the
Markov stream, drawn on the card), then drives three steps and one sync
through the window's own calls, reading the first gradient from Adam's
first moment after the first step and each leaf's change after the sync;
the second and third steps give the pace. The window runs whole sync
cycles (``sync_gap`` steps, then the sync) for as long as fills
``seconds`` at that pace, the loss read after every step as the launcher
reads it, each sync timed between two synchronises. A traced cycle
(``--trace 1``) follows the window. The program's state is freed before
the reference follows the checked steps.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench.reference import compare, data, lm_ref, trace, work

CHECK_STEPS = 3
# the program's tree leaves by the reference's names
LEAF_NAMES = {"unit/0/mixer/wq": "wq", "unit/0/mixer/wk": "wk", "unit/0/mixer/wv": "wv",
              "unit/0/mixer/wo": "wo", "unit/0/ffn/w_gate": "w_gate", "unit/0/ffn/w_up": "w_up",
              "unit/0/ffn/w_down": "w_down", "unit/0/norm1/scale": "norm1",
              "unit/0/norm2/scale": "norm2", "embed/table": "table",
              "final_norm/scale": "final_norm"}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def program_config(cfg: dict):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=cfg["name"], family="dense", n_layers=cfg["n_layers"],
                      d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                      n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"],
                      vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
                      rope_theta=cfg["rope_theta"], norm_eps=cfg["norm_eps"],
                      dtype=cfg["dtype"], tie_embeddings=cfg["tie_embeddings"])


def program_tree(w: Dict[str, torch.Tensor]) -> dict:
    """The benchmark's weights in the program's tree layout (one unit of
    one attention layer, its leaves stacked over the layers)."""
    return {"unit": ({"norm1": {"scale": w["norm1"]}, "norm2": {"scale": w["norm2"]},
                      "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                      "ffn": {k: w[k] for k in ("w_gate", "w_up", "w_down")}},),
            "embed": {"table": w["table"]}, "final_norm": {"scale": w["final_norm"]}}


def _named(tree, r=None) -> Dict[str, torch.Tensor]:
    from repro_torch import tree as T

    return {LEAF_NAMES[p]: (x if r is None else x[r]) for p, x in T.leaves_with_path(tree)}


def run(cell) -> dict:
    from repro_torch import optim
    from repro_torch.core import algorithms, spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.models.layers import dtype_of

    cfg, mix, seed, dev = cell.config, cell.mix, cell.seed, torch.device(cell.device)
    R, B, S, gap = mix["replicas"], mix["batch_per_replica"], mix["seq_len"], mix["sync_gap"]
    marks = {"driver": time.perf_counter() - cell.t0}
    pcfg = program_config(cfg)
    opt = optim.make(mix["optimizer"], mix["lr"])
    sync_cfg = SyncConfig(algo=mix["algo"], alpha=mix["alpha"]).validate()
    params = program_tree(data.lm_weights(cfg, seed, dev, dtype_of(cfg["dtype"])))
    state = {"stack": spmd.stack_replicas(params, R),
             "opt": spmd.stack_replicas(opt.init(params), R),
             "algo": algorithms.get(mix["algo"]).init_state(params, sync_cfg)}
    del params
    train_step = spmd.make_train_step(pcfg, opt, "shadow")
    sync_step = spmd.make_sync_step(pcfg, sync_cfg)
    bank = [t.reshape(R, B, S) for t in data.markov_tokens(
        seed, mix["bank_steps"], R * B, S, mix["stream_vocab"], dev)]
    marks["built"] = time.perf_counter() - cell.t0
    losses: List[float] = []
    step_s: List[float] = []
    sync_s: List[float] = []

    def step(it: int) -> None:
        _sync(dev)
        t0 = time.perf_counter()
        state["stack"], state["opt"], loss = train_step(
            state["stack"], state["opt"], {"tokens": bank[it % len(bank)]})
        losses.extend(loss.float().tolist())  # the launcher reads the loss every step
        step_s.append(time.perf_counter() - t0)

    def sync() -> None:
        _sync(dev)
        t0 = time.perf_counter()
        state["stack"], state["algo"] = sync_step(state["stack"], state["algo"])
        _sync(dev)
        sync_s.append(time.perf_counter() - t0)

    # the checked steps and sync, through the window's own calls
    grad: Dict[str, float] = {}
    for it in range(CHECK_STEPS):
        step(it)
        if it == 0:  # Adam's first moment after one step is (1 - b1) * g
            for r in range(R):
                m = _named(state["opt"]["m"], r)
                grad.update(lm_ref.leaf_norms({k: v / (1 - lm_ref.B1) for k, v in m.items()},
                                              f"r{r}/"))
    sync()
    init = data.lm_weights(cfg, seed, dev, dtype_of(cfg["dtype"]))
    change: Dict[str, float] = {}
    for r in range(R):
        now = _named(state["stack"], r)
        change.update(lm_ref.leaf_norms({k: now[k].float() - init[k].float() for k in now},
                                        f"r{r}/"))
    now = _named(state["algo"])
    change.update(lm_ref.leaf_norms({k: now[k].float() - init[k].float() for k in now}, "ps/"))
    del init, now
    prog = {"losses": list(losses), "grad": grad, "change": change}
    marks["checked"] = time.perf_counter() - cell.t0
    pace = sum(step_s[1:]) / len(step_s[1:])  # the first step pays the first calls
    cycles = max(1, round(cell.seconds / (gap * pace + sync_s[-1])))
    n_steps = cycles * gap

    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses.clear()
    sync_s.clear()
    it0 = CHECK_STEPS
    _sync(dev)
    start = time.perf_counter()
    for i in range(n_steps):
        step(it0 + i)
        if (i + 1) % gap == 0:
            sync()
    _sync(dev)
    end = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    tokens = n_steps * R * B * S
    rec = {"setup_s": start - cell.t0, "window_s": end - start, "iters": n_steps,
           "tokens": tokens, "sync_s": list(sync_s), "step_s": step_s[-n_steps:],
           "flops_per_iter": work.lm_flops_per_step(cfg, R * B * S, S),
           "window_peak_bytes": window_peak,
           "attempted": n_steps, "failed": sum(not math.isfinite(x) for x in losses) // R}
    if cell.trace and dev.type == "cuda":
        it1 = it0 + n_steps

        def cycle():
            for i in range(gap):
                step(it1 + i)
            sync()

        _, summ, rec["trace_wall_s"] = trace.traced(torch, cycle)
        rec["trace"] = summ
        rec["trace_iters"] = gap
    t_trace = time.perf_counter()
    mem = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec["memory_peak_bytes"] = max(setup_peak, window_peak, mem)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = lm_ref.run(cfg, mix, seed, bank[:CHECK_STEPS], dev, steps=CHECK_STEPS)
    rec["phases_s"] = {"setup": start - cell.t0, "setup_marks": marks, "window": end - start,
                       "trace": t_trace - end, "reference": time.perf_counter() - t_trace}
    rec["checks"] = compare.checks(prog, ref, cell.limits, grad_of=lm_ref.grad_of)
    rec["worst"] = compare.where(prog, ref, grad_of=lm_ref.grad_of)
    return rec
