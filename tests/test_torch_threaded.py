"""The port's ThreadedShadowRunner: against the JAX package's where the run
is deterministic (one trainer, fixed_rate, no supervisor), and through the
reference's fault paths where it is not.

For the parity run the port's draws are monkeypatched to the JAX package's:
``dlrm.init_dense`` and ``EmbeddingShards.init`` hand in the JAX initial
weights and tables, ``ctr.gen_batch`` / ``make_teacher`` the JAX batches.
The JAX run goes through its Pallas kernels in interpret mode.
"""
import functools
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro.embeddings import shards as jshards  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, streams, sync  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.core.modeswitch import ModeConfig, ModeController  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.core.scheduler import StragglerPolicy  # noqa: E402
from repro_torch.core.supervision import SupervisorConfig  # noqa: E402
from repro_torch.data import ctr  # noqa: E402
from repro_torch.embeddings import shards  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()
PARITY = dict(n_trainers=1, batch_size=16, seed=0, n_emb_shards=3, supervise=False)
PARITY_ITERS = 12


@functools.lru_cache(maxsize=None)
def _jax_parity_run(engine, algo="easgd"):
    r = jrunners.ThreadedShadowRunner(
        jcfg.tiny(), jsync.SyncConfig(algo=algo, mode="fixed_rate", gap=4, engine=engine),
        optimizer=joptim.adagrad(0.02), **PARITY)
    out = r.run(PARITY_ITERS)
    kw, ke = jax.random.split(jax.random.PRNGKey(PARITY["seed"]))
    w0 = jax.tree.map(np.array, jdlrm.init_dense(jcfg.tiny(), kw))
    packed0 = jax.tree.map(np.array, jshards.packed_state(
        r.plan, jshards.EmbeddingShards.init(r.plan, ke).states))
    final_w = jax.tree.map(np.array, out["w"][0])
    return w0, packed0, out["sync_count"], out["train_loss"], final_w, \
        jax.tree.map(np.array, out["emb_state"])


@pytest.fixture
def jax_draws(monkeypatch):
    """Point the port's initial draws and data stream at the JAX package's."""
    def use(w0, packed0):
        monkeypatch.setattr(dlrm, "init_dense", lambda cfg, gen, dtype=torch.float32, device=None:
                            interop.dense_from_numpy(w0, device or "cpu"))
        monkeypatch.setattr(shards.EmbeddingShards, "init", classmethod(
            lambda cls, plan, gen, retry=None, cache=None, device=None:
            cls(plan, interop.shard_states_from_numpy(plan, packed0, device or "cpu"),
                retry=retry)))
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})
    return use


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_one_trainer_fixed_rate_matches_jax(jax_draws, engine):
    w0, packed0, j_syncs, j_loss, j_w, j_emb = _jax_parity_run(engine)
    jax_draws(w0, packed0)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(mode="fixed_rate", gap=4, engine=engine),
        optimizer=optim.adagrad(0.02), device="cpu", **PARITY)
    out = r.run(PARITY_ITERS)
    assert out["sync_count"] == j_syncs == PARITY_ITERS // 4
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    for a, b in zip(T.leaves(out["w"][0]), jax.tree.leaves(j_w)):
        np.testing.assert_allclose(a.numpy(), b, **TRAJ)
    for k in ("table", "acc"):
        np.testing.assert_allclose(out["emb_state"][k].numpy(), j_emb[k], **TRAJ)


def _runner(mode="shadow", fault=None, n_trainers=2, **kw):
    kw.setdefault("supervisor_config", SupervisorConfig(
        heartbeat_deadline_s=0.5, check_interval_s=0.01, backoff_s=0.05, max_restarts=3))
    return runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", alpha=0.5, mode=mode, gap=3),
        n_trainers=n_trainers, batch_size=16, optimizer=optim.adagrad(0.02),
        sync_sleep_s=0.005, fault_spec=fault, device="cpu", **kw)


def test_two_trainer_shadow_run_syncs_and_trains():
    r = _runner()
    r.warmup()
    out = r.run(12)
    assert out["sync_count"] > 0 and out["sync_rounds"] > 0
    assert out["iter_count"] == [12, 12]
    assert all(math.isfinite(x) for x in out["train_loss"])
    gen = torch.Generator().manual_seed(0)
    dlrm.init_dense(CFG, gen)  # the run draws w0 first, then the tables
    start = shards.packed_state(r.plan, shards.EmbeddingShards.init(r.plan, gen).states)
    assert not torch.equal(out["emb_state"]["table"], start["table"])  # the tables moved
    assert set(out) >= {"cache_stats", "pipeline_stats", "mode", "mode_transitions",
                        "policy_transitions", "supervision_events", "emb_state", "w"}
    assert out["cache_stats"] == {} and out["pipeline_stats"] == {} and out["mode"] == "shadow"


def test_fixed_rate_rounds_are_exact():
    out = _runner("fixed_rate", n_trainers=3).run(9)
    assert out["sync_count"] == 3 * (9 // 3)
    assert out["iter_count"] == [9, 9, 9]


def test_crash_completes_and_leaves_the_cohort():
    out = _runner(fault=FaultSpec(crash_at={1: 3})).run(10)
    assert out["iter_count"] == [10, 3]
    assert [(e.kind, e.slot) for e in out["membership_events"]] == [("fail", 1)]
    assert math.isfinite(out["train_loss"][0])


def test_trainer_exception_reraised_with_slot_provenance():
    r = _runner(fault=FaultSpec(raise_at={1: 3}))
    with pytest.raises(RuntimeError, match=r"slot 1.*injected trainer"):
        r.run(10)
    fails = [e for e in r.membership.events if e.kind == "fail"]
    assert fails and fails[0].slot == 1 and "RuntimeError" in fails[0].reason
    assert r.iter_count[0] == 10  # the survivor trained to completion


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_join_bootstraps_from_the_ps_plane(engine, monkeypatch):
    """The joiner adopts the EASGD PS plane bitwise, with a fresh optimizer
    state, then trains."""
    seen = {}
    orig = runners.ThreadedShadowRunner._bootstrap_join

    def spy(self, i):
        orig(self, i)
        seen["w"] = T.map(torch.clone, streams.consume(self.w[i]))
        seen["ps"] = T.map(torch.clone, streams.consume(self.algo_state))
        seen["opt"] = self.opt_states[i]

    monkeypatch.setattr(runners.ThreadedShadowRunner, "_bootstrap_join", spy)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(mode="shadow", gap=3, engine=engine), n_trainers=3, batch_size=16,
        optimizer=optim.adagrad(0.02), sync_sleep_s=0.005, fault_spec=FaultSpec(join_at={2: 4}),
        device="cpu")
    out = r.run(10)
    kinds = [(e.kind, e.slot) for e in out["membership_events"]]
    assert ("join", 2) in kinds and ("activate", 2) in kinds
    for a, b in zip(T.leaves(seen["w"]), T.leaves(seen["ps"])):
        assert torch.equal(a, b)
    assert all(torch.equal(x, torch.zeros_like(x)) for x in T.leaves(seen["opt"]))
    assert out["iter_count"][2] == 6 and math.isfinite(out["train_loss"][2])


def test_sync_crash_is_restarted_and_syncing_resumes():
    # the trainers' sleeps keep the run well past the restart backoff
    out = _runner(fault=FaultSpec(sync_crash_at=2, straggler_sleep_s={0: 0.005, 1: 0.005})).run(40)
    assert out["sync_restarts"] >= 1
    assert out["sync_count"] > out["sync_count_at_restart"][0]
    kinds = [e.kind for e in out["supervision_events"]]
    assert "death" in kinds and "restart" in kinds and not out["sync_degraded"]
    assert any(e.kind == "sync_restart" for e in out["membership_events"])
    assert out["iter_count"] == [40, 40]


def test_ps_fail_serves_snapshot_then_recovers():
    fault = FaultSpec(ps_fail_at={0: 3}, ps_recover_after_s=0.1,
                      straggler_sleep_s={0: 0.01, 1: 0.01})
    out = _runner(fault=fault).run(30)
    kinds = [(e.kind, e.shard) for e in out["shard_events"]]
    assert ("ps_fail", 0) in kinds and ("ps_recover", 0) in kinds
    assert out["stale_lookups"][0] >= 1 and out["dropped_updates"][0] >= 1
    assert sum(out["dropped_updates"][1:]) == 0 and sum(out["stale_lookups"][1:]) == 0
    assert out["iter_count"] == [30, 30]
    notes = [e.kind for e in out["membership_events"]]
    assert "ps_fail" in notes and "ps_recover" in notes


@pytest.mark.parametrize("option", ["cache", "pipeline", "straggler_policy", "mode_controller"])
def test_unported_options_raise(option):
    """Every option is ported now: each is accepted and trains (held further
    by tests/test_torch_{cache,pipeline,scheduler,modeswitch}.py)."""
    if option == "cache":
        out = _runner(cache=CacheConfig(hot_frac=0.5, lookahead=1)).run(3)
        assert out["iter_count"] == [3, 3] and out["cache_stats"]["lookups"] > 0
    elif option == "pipeline":
        out = _runner(pipeline=PipelineConfig(depth=2)).run(3)
        assert out["iter_count"] == [3, 3] and out["pipeline_stats"]["steps"] == 6
        assert out["pipeline_stats"]["worker_errors"] == 0
    elif option == "straggler_policy":
        out = _runner(straggler_policy=StragglerPolicy(n_slots=2)).run(3)
        assert out["iter_count"] == [3, 3]
        # two slots at the default quorum of two: watched, never demoted
        assert all(to != "demoted" for *_, to in out["policy_transitions"])
    else:
        ctl = ModeController(ModeConfig(start_mode="shadow"))
        out = _runner(mode_controller=ctl).run(3)
        assert out["iter_count"] == [3, 3] and out["mode"] == "shadow"
        assert out["mode_transitions"] == []


def test_chaos_needs_the_supervisor_and_a_shadow_thread():
    with pytest.raises(ValueError, match="supervise"):
        _runner(fault=FaultSpec(sync_crash_at=1), supervise=False)
    with pytest.raises(ValueError, match="fixed_rate"):
        _runner("fixed_rate", fault=FaultSpec(sync_crash_at=1))
    with pytest.raises(ValueError, match="shard"):
        _runner(fault=FaultSpec(ps_fail_at={9: 1}))


def test_without_a_card_the_runner_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runners.ThreadedShadowRunner(CFG, sync.SyncConfig(), n_trainers=1, batch_size=8,
                                         optimizer=optim.adagrad(0.02), device=device)


def test_round_publishes_new_planes_and_keeps_inputs():
    """EASGD's threaded round replaces the planes it is handed and never
    writes the old ones (trainer threads may still read them)."""
    fs = runners._dense_flatspace(CFG)
    rnd = runners.algorithms.get("easgd").make_shadow_round(sync.SyncConfig(alpha=0.3), fs)
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn((fs.n_rows, 128), generator=gen) for _ in range(3)]
    ps = torch.randn((fs.n_rows, 128), generator=gen)
    old = [w.clone() for w in ws] + [ps.clone()]
    inputs = list(ws)
    new_ps, n = rnd(ws, ps)
    assert n == 3 and all(a is not b for a, b in zip(ws, inputs)) and new_ps is not ps
    for a, b in zip(inputs + [ps], old):
        assert torch.equal(a, b)


def test_threads_share_one_event_discipline_on_cpu():
    """On the CPU a published value carries no event and consume is the
    identity, from any thread."""
    pub = streams.publish(torch.ones(3))
    got = []
    t = threading.Thread(target=lambda: got.append(streams.consume(pub)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and pub.event is None and got[0] is pub.value


@pytest.mark.parametrize("engine", ["flat", "pytree"])
@pytest.mark.parametrize("algo", ["ma", "bmuf"])
def test_one_trainer_fixed_rate_ma_bmuf_match_jax(jax_draws, algo, engine):
    """MA's and BMUF's threaded rounds (mean, BMUF's global step, the
    out-of-place pull-back) train the one trainer as the JAX runner does."""
    w0, packed0, j_syncs, j_loss, j_w, j_emb = _jax_parity_run(engine, algo)
    jax_draws(w0, packed0)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo=algo, mode="fixed_rate", gap=4, engine=engine),
        optimizer=optim.adagrad(0.02), device="cpu", **PARITY)
    out = r.run(PARITY_ITERS)
    assert out["sync_count"] == j_syncs == PARITY_ITERS // 4
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    for a, b in zip(T.leaves(out["w"][0]), jax.tree.leaves(j_w)):
        np.testing.assert_allclose(a.numpy(), b, **TRAJ)
    for k in ("table", "acc"):
        np.testing.assert_allclose(out["emb_state"][k].numpy(), j_emb[k], **TRAJ)


def _algo_runner(algo, n_trainers=2, mode="shadow", **kw):
    return runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo=algo, alpha=0.5, mode=mode, gap=3), n_trainers=n_trainers,
        batch_size=16, optimizer=optim.adagrad(0.02), sync_sleep_s=0.005, device="cpu", **kw)


@pytest.mark.parametrize("algo", ["ma", "bmuf", "gossip"])
def test_two_trainer_shadow_run_syncs_and_trains_other_algos(algo):
    r = _algo_runner(algo)
    r.warmup()
    out = r.run(10)
    assert out["sync_count"] > 0 and out["sync_rounds"] > 0
    assert out["iter_count"] == [10, 10]
    assert all(math.isfinite(x) for x in out["train_loss"])
    assert not out["sync_degraded"] and out["sync_restarts"] == 0


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_ma_join_bootstraps_from_the_live_mean(engine, monkeypatch):
    """Under MA a joiner's plane is the live cohort's mean (the base
    ``join_plane_flat``: K5 ``replica_mean_rows``), bitwise against the port's
    own plain mean of the donors' planes the join hook was handed (trainers
    keep publishing new planes meanwhile, so they are read inside the hook)."""
    from repro_torch.kernels.ma_update.ref import replica_mean_rows_ref

    algo = runners.algorithms.get("ma")
    seen = {}
    if engine == "flat":
        orig = algo.join_plane_flat

        def spy(stack, state, active, *rest):
            seen["stack"], seen["active"] = stack.clone(), np.asarray(active)
            plane, state = orig(stack, state, active, *rest)
            seen["w"] = plane.clone()
            return plane, state

        monkeypatch.setattr(algo, "join_plane_flat", spy)
    else:
        orig = algo.on_join

        def spy(stack, slot, state, active, *rest):
            seen["stack"] = T.map(torch.clone, stack)
            seen["slot"], seen["active"] = slot, np.asarray(active)
            new, state = orig(stack, slot, state, active, *rest)
            seen["w"] = T.map(lambda x: x[slot].clone(), new)
            return new, state

        monkeypatch.setattr(algo, "on_join", spy)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="ma", mode="shadow", gap=3, engine=engine), n_trainers=3,
        batch_size=16, optimizer=optim.adagrad(0.02), sync_sleep_s=0.005,
        fault_spec=FaultSpec(join_at={2: 4}), device="cpu")
    out = r.run(10)
    assert ("activate", 2) in [(e.kind, e.slot) for e in out["membership_events"]]
    rows = torch.tensor([0, 1], dtype=torch.int32)
    if engine == "flat":  # the stack holds the two donors alone
        assert seen["active"].tolist() == [True, True] and seen["stack"].shape[0] == 2
        assert torch.equal(seen["w"], replica_mean_rows_ref(seen["stack"], rows))
    else:  # the compact stack holds the two donors, then the joiner; the
        # tree join is the masked mean: sum over live rows / count
        assert seen["slot"] == 2 and seen["active"].tolist() == [True, True, False]
        for got, x in zip(T.leaves(seen["w"]), T.leaves(seen["stack"])):
            torch.testing.assert_close(got, replica_mean_rows_ref(x, rows), rtol=1e-6,
                                       atol=1e-7)
    assert out["iter_count"][2] == 6 and math.isfinite(out["train_loss"][2])


@pytest.mark.parametrize("mode,supervise", [("shadow", True), ("fixed_rate", True),
                                            ("shadow", False)])
def test_finished_runner_holds_no_reference_cycle(mode, supervise):
    """With the cyclic collector off, a finished runner is freed as soon as
    its last name is dropped: its tables, accumulators and snapshots (device
    memory on the card) go with it."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        r = runners.ThreadedShadowRunner(CFG, sync.SyncConfig(mode=mode, gap=2), n_trainers=2,
                                         batch_size=8, optimizer=optim.adagrad(0.02),
                                         supervise=supervise, device="cpu")
        out = r.run(3)
        assert out["iter_count"] == [3, 3]
        ref, emb = weakref.ref(r), weakref.ref(r.emb)
        del r, out
        assert ref() is None and emb() is None
    finally:
        gc.enable()
