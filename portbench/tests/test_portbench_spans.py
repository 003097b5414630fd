"""The program's spans (``repro_torch/tracing.py``) over the bodies the
benchmark's drivers trace, on the CPU.

The program counts the shadow landings as the DLRM driver's replay of the
shadow clocks does, and the bodies the two drivers trace make every span
under ``tracing.collect()``. The drivers themselves never collect: a span
reaches no metric of the benchmark yet (PERF.md §7 says which edit would
carry the report into a run's record).
"""
from __future__ import annotations

import pytest
import torch

from portbench.drivers import dlrm_sim, lm_train
from portbench.reference import data
from portbench.tests.test_portbench_runs import tiny

SIM_SPANS = {"sim.iter", "sim.lookup", "sim.dense", "sim.update", "sim.loss_wait",
             "sim.launch", "sim.land"}
LM_SPANS = {"train.step", "train.fwd_bwd", "train.optim", "train.sync", "attn.fwd",
            "attn.bwd"}
SEED = 2**31 + 777


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sim(cell, batch_size=8):
    from repro_torch import optim
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.sync import SyncConfig

    mix = cell.mix
    return HogwildSim(dlrm_sim.program_config(cell.config),
                      SyncConfig(algo=mix["algo"], mode=mix["mode"], gap=mix["sync_gap"],
                                 alpha=mix["alpha"], delay=mix["sync_delay"], engine="flat"),
                      n_trainers=mix["trainers"], n_threads=mix["threads"],
                      batch_size=batch_size, optimizer=optim.make(mix["optimizer"], mix["lr"]),
                      emb_lr=mix["emb_lr"], device="cpu")


def _tiny(name):
    return tiny(name, SEED)


@pytest.mark.parametrize("n", (1, 2, 7, 20))
def test_program_counts_the_landings_the_replay_counts(n):
    from repro_torch import tracing

    cell = _tiny("dlrm-ctr.sim-easgd.b4096")
    mix = cell.mix
    sim = _sim(cell)
    with tracing.collect() as spans:
        sim.run(n)
    rep = spans.report()
    want = len(dlrm_sim.shadow_landings(mix["trainers"], mix["sync_gap"], mix["sync_delay"], n))
    assert rep.get("sim.land", {"count": 0})["count"] == want
    assert rep["sim.iter"]["count"] == n


def test_dlrm_traced_body_makes_every_span():
    """The body ``dlrm_sim.run`` traces (one ``run`` of ``TRACE_ITERS``
    iterations on the benchmark's state, its batches from the harness's
    ``make_batch``), under collection."""
    from repro_torch import tracing

    cell = _tiny("dlrm-ctr.sim-easgd.b4096")
    cfg, mix = cell.config, cell.mix
    R, M, B = mix["trainers"], mix["threads"], mix["batch_per_thread"]
    sim = _sim(cell, B)
    teacher = data.make_teacher(cfg, SEED, "cpu")
    sim.make_batch = lambda it: {
        k: v.reshape(R, M, B, *v.shape[1:])
        for k, v in data.ctr_batch(cfg, teacher, SEED, it, R * M * B).items()}
    table = data.dlrm_table(cfg, SEED, "cpu")
    st = sim._state_from(data.dlrm_dense(cfg, SEED, "cpu"),
                         {"table": table, "acc": torch.zeros_like(table)})
    with tracing.collect() as spans:
        sim.run(dlrm_sim.TRACE_ITERS, state=st)
    rep = spans.report()
    assert set(rep) == SIM_SPANS
    assert rep["sim.iter"]["count"] == dlrm_sim.TRACE_ITERS
    assert rep["sim.iter"]["host_s"] > rep["sim.loss_wait"]["host_s"] > 0
    assert all(v["stream_s"] is None for v in rep.values())  # no stream time off the card


def test_lm_traced_cycle_makes_every_span(monkeypatch):
    """The cycle ``lm_train.run`` traces (``sync_gap`` steps, then a sync)
    on the benchmark's weights, under collection, with the query chunks
    below S so the chunk remat runs."""
    from repro_torch import optim, tracing
    from repro_torch.core import algorithms, spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.models import layers

    cell = _tiny("minicpm-2b-d24.train-easgd.s2048")
    cfg, mix = cell.config, cell.mix
    R, B, S, gap = mix["replicas"], mix["batch_per_replica"], mix["seq_len"], mix["sync_gap"]
    monkeypatch.setattr(layers, "Q_CHUNK", S // 2)
    pcfg = lm_train.program_config(cfg)
    opt = optim.make(mix["optimizer"], mix["lr"])
    sc = SyncConfig(algo=mix["algo"], alpha=mix["alpha"]).validate()
    params = lm_train.program_tree(data.lm_weights(cfg, SEED, "cpu", torch.float32))
    stack, opt_state = spmd.stack_replicas(params, R), spmd.stack_replicas(opt.init(params), R)
    algo = algorithms.get(mix["algo"]).init_state(params, sc)
    train_step, sync_step = spmd.make_train_step(pcfg, opt, "shadow"), spmd.make_sync_step(pcfg, sc)
    bank = data.markov_tokens(SEED, gap, R * B, S, mix["stream_vocab"], "cpu")
    with tracing.collect() as spans:
        for i in range(gap):
            stack, opt_state, _ = train_step(stack, opt_state, {"tokens": bank[i].reshape(R, B, S)})
        stack, algo = sync_step(stack, algo)
    rep = spans.report()
    assert set(rep) == LM_SPANS
    L = cfg["n_layers"]
    assert rep["train.step"]["count"] == gap and rep["train.sync"]["count"] == 1
    assert rep["attn.fwd"]["count"] == 2 * L * R * gap
    assert rep["attn.bwd"]["count"] == L * R * gap
    assert all(v["stream_s"] is None for v in rep.values())  # no stream time off the card

