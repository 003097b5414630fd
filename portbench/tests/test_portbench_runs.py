"""Runs of the benchmark's cells at a tiny size on the CPU, past the
harness's look for a card.

The plain references agree with the program (``repro_torch``) where both
compute in f32; a run whose timed path is broken underneath (a step that
returns its state unchanged, half of each batch left out of the loss, the
EASGD exchange left out) comes out not ``correct``; the control (the
reference in the precision below the configuration's) fails the cell's
committed limits. Beside them, the yardstick's arithmetic: the trace's
window, busy time and idle gaps, the FLOP counts, the shadow-clock replay,
the seeded inputs.
"""
from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import control
from portbench import run as harness
from portbench.drivers import dlrm_sim
from portbench.reference import data, trace, work

DLRM = "dlrm-ctr.sim-easgd.b4096"
LM = "minicpm-2b-d24.train-easgd.s2048"
BENCH = harness.manifest()
SEED = 2**31 + 12345


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name: str, seed: int = SEED, dtype: str = "float32") -> harness.Cell:
    cell = harness.make_cell(BENCH, name, seed, 0.3, False, "cpu")
    cell.t0 = time.perf_counter()
    if cell.config["driver"] == "dlrm_sim":
        cell.config.update(n_sparse_features=4, embedding_dim=16, multi_hot=2,
                           table_sizes=[1000, 500, 200, 50], bottom_mlp=[32, 16], top_mlp=[32, 1])
        cell.mix.update(batch_per_thread=32)
    else:
        cell.config.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                           d_ff=96, vocab_size=300, dtype=dtype)
        cell.mix.update(batch_per_replica=2, seq_len=32, stream_vocab=64, bank_steps=8)
    return cell


@pytest.mark.parametrize("name", [DLRM, LM])
def test_reference_agrees_with_the_program_in_f32(name):
    out = harness.execute(BENCH, tiny(name))
    assert out["correct"], out["checks"]
    assert all(c["value"] <= 1e-4 for c in out["checks"].values()), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in harness.metrics_of(BENCH, name, False)}
    assert list(out)[-1] == "checks"


def _stale_step(monkeypatch):
    """Every iteration's state put back as it was: a step that returns its
    state unchanged (the loss still computed)."""
    from repro_torch.core.runners import HogwildSim

    orig = HogwildSim._train_iter

    def stale(self, st, *a, **kw):
        saved = [x.clone() for x in (st.w_stack, st.emb_state["table"], st.emb_state["acc"])]
        opt = [x.clone() for x in _leaves(st.opt_stack)]
        loss = orig(self, st, *a, **kw)
        st.w_stack = saved[0]
        st.emb_state["table"].copy_(saved[1])
        st.emb_state["acc"].copy_(saved[2])
        for x, y in zip(_leaves(st.opt_stack), opt):
            x.copy_(y)
        return loss

    monkeypatch.setattr(HogwildSim, "_train_iter", stale)


def _leaves(tree):
    from repro_torch import tree as T

    return T.leaves(tree)


def _half_batch_dlrm(monkeypatch):
    from repro_torch.models import dlrm

    orig = dlrm.bce_loss
    monkeypatch.setattr(dlrm, "bce_loss", lambda lg, lb: orig(lg[..., :lg.shape[-1] // 2],
                                                             lb[..., :lb.shape[-1] // 2]))


def _no_sync(monkeypatch):
    from repro_torch.core import algorithms

    monkeypatch.setattr(algorithms.EASGD, "land_flat",
                        lambda self, buf, state, *a, **kw: (buf, state))
    monkeypatch.setattr(algorithms.EASGD, "land",
                        lambda self, stack, state, *a, **kw: (stack, state))


def _no_update_lm(monkeypatch):
    from repro_torch import optim

    monkeypatch.setattr(optim, "update_in_place", lambda *a, **kw: None)


def _half_batch_lm(monkeypatch):
    from repro_torch.models import transformer

    orig = transformer.loss_fn

    def half(params, cfg, batch, **kw):
        toks = batch["tokens"]
        return orig(params, cfg, {**batch, "tokens": toks[:toks.shape[0] // 2]}, **kw)

    monkeypatch.setattr(transformer, "loss_fn", half)


FAULTS = {(DLRM, "unchanged"): _stale_step, (DLRM, "half_batch"): _half_batch_dlrm,
          (DLRM, "no_sync"): _no_sync, (LM, "unchanged"): _no_update_lm,
          (LM, "half_batch"): _half_batch_lm, (LM, "no_sync"): _no_sync}


@pytest.mark.parametrize("name,fault", sorted(FAULTS), ids=lambda x: x)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[name, fault](monkeypatch)
    out = harness.execute(BENCH, tiny(name))
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("name,variant,dtype", [(DLRM, "tf32", "float32"),
                                                (LM, "fp8", "bfloat16")])
def test_control_fails_the_committed_limits(name, variant, dtype):
    (checked, _), _ = control.readings(tiny(name, dtype=dtype), variant)
    assert any(c["value"] > c["limit"] for c in checked.values()), checked


def test_trace_summary_window_busy_and_gaps():
    m = trace.MARKER_CYCLES / trace.SPIN_HZ
    dev = [(0.0, 1e-7, "spin_kernel", 1),  # a sacrificial spin: too short for a marker
           (1.0, 1.0 + m, "spin_kernel", 2), (1.1, 1.2, "k_a", 3), (1.15, 1.3, "k_b", 4),
           (1.5, 1.6, "k_a", 5), (2.0, 2.0 + m, "spin_kernel", 6), (2.5, 2.6, "late", 7),
           (1.12, 1.45, trace.HARNESS, 0)]  # the host range's device record: no work
    # the harness's range holds the runtime call that launched k_b; an
    # operator record's own id (4) is no launch
    host = [(1.0, 2.0, "ProfilerStep#1", 0), (1.3, 1.5, "aten::item", 3),
            (1.01, 1.03, trace.HARNESS, 0), (1.015, 1.02, "cudaLaunchKernel", 4),
            (1.02, 1.025, "aten::mul", 5), (1.035, 1.04, "cudaLaunchKernel", 3)]
    s = trace.summary(dev, host)
    assert s["window_s"] == pytest.approx(1.0 - m)
    assert s["busy_s"] == pytest.approx(0.3)
    assert s["launches"] == 3
    assert s["kernels"]["k_a"] == [pytest.approx(0.2), 2]
    assert s["harness_s"] == pytest.approx(0.15)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(0.2)
    assert gaps["ProfilerStep#1"] == pytest.approx(0.5 - m)
    assert trace.summary(dev[:2], host) is None  # the closing marker lost


def test_model_flops():
    dlrm = harness._json(harness.ROOT, "portbench", "configs", "dlrm-ctr.json")
    # 2 x (2,365,184 MLP MACs + 351 x 128 interaction MACs) x 3
    assert work.dlrm_flops_per_example(dlrm) == 3 * 2 * (2_365_184 + 351 * 128)
    lm = harness._json(harness.ROOT, "portbench", "configs", "minicpm-2b-d24.json")
    tokens = 2 * 4 * 2048
    n = work.lm_params_for_flops(lm)
    assert n == 24 * (4 * 2304 * 2304 + 3 * 2304 * 5760) + 122_753 * 2304
    assert work.lm_flops_per_step(lm, tokens, 2048) == pytest.approx(1.9410e14, rel=1e-3)


def test_shadow_landing_replay_matches_the_program():
    cell = tiny(DLRM)
    from repro_torch import optim
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.sync import SyncConfig

    mix = cell.mix
    sim = HogwildSim(dlrm_sim.program_config(cell.config),
                     SyncConfig(algo="easgd", gap=mix["sync_gap"], delay=mix["sync_delay"]),
                     n_trainers=mix["trainers"], n_threads=mix["threads"], batch_size=8,
                     optimizer=optim.adagrad(0.02), device="cpu")
    for n in (1, 2, 7, 20):
        got = sim.run(n)["sync_count"]
        assert got == sum(dlrm_sim.shadow_landings(mix["trainers"], mix["sync_gap"],
                                                   mix["sync_delay"], n)), n


def test_inputs_follow_the_seed():
    cfg = tiny(DLRM).config
    t = data.make_teacher(cfg, SEED, "cpu")
    a, b = data.ctr_batch(cfg, t, SEED, 3, 64), data.ctr_batch(cfg, t, SEED, 3, 64)
    c = data.ctr_batch(cfg, t, SEED, 4, 64)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sparse"], c["sparse"])
    sizes = torch.tensor(cfg["table_sizes"])[None, :, None]
    assert bool((a["sparse"] >= 0).all() and (a["sparse"] < sizes).all())
    toks = data.markov_tokens(SEED, 4, 3, 16, 64, "cpu")
    assert torch.equal(toks[2], data.markov_tokens(SEED, 4, 3, 16, 64, "cpu")[2])
    assert int(toks[0].max()) < 64 and data.key(-1) == data.key(2**64 - 1)
    assert math.isfinite(float(t["true_rows"].sum()))
