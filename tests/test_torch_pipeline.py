"""The port's step pipelining (``repro_torch/core/pipeline.py``) and its
wiring through both runners.

* The ``StepPipeline`` state machine driven with synthetic prepare/stage
  functions (the cases of ``tests/test_pipeline.py``): a hazard-free stream
  overlaps, a colliding one serializes (counted), depth 1 is serial,
  ``drain()`` and epoch/shard-token mismatches drop staged values, a raising
  stager degrades to serial, ``close`` stops the worker.
* Pipelined == serial, bitwise, inside the port: ``HogwildSim`` on both
  engines, cached and uncached, at depths 2 and 3, through elastic events
  and a mode handoff (both drain), and when every step hazards; the
  one-trainer fixed_rate ``ThreadedShadowRunner``.
* Against the JAX package: the port's pipelined sim follows the JAX
  pipelined sim at the trajectory tolerance, with equal ``pipeline_stats``
  (the JAX batches fed to the port).
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import optim as joptim  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro.embeddings import cache as jcache  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig, PipelineStats, StepPipeline  # noqa: E402
from repro_torch.data import ctr  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig, CachedStore  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()
# wide tables: consecutive batches rarely share a row, so staging happens
BIG = dataclasses.replace(CFG, table_sizes=(50_000,) * 4, n_sparse_features=4, multi_hot=2)
# single-row tables: every batch reads row 0 of every table, every stage hazards
ONE = dataclasses.replace(CFG, table_sizes=(1,) * 8)
CACHE = dict(hot_rows=2048, lookahead=2)


# ---------------------------------------------------------------------------
# StepPipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,ok", [(2, True), (1, True), (3, True), (0, False), (-2, False)])
def test_config_validation(depth, ok):
    assert PipelineConfig().depth == 2
    if ok:
        assert PipelineConfig(depth=depth).validate().depth == depth
    else:
        with pytest.raises(ValueError, match="depth"):
            PipelineConfig(depth=depth).validate()


def _drive(pipe, n):
    """The runner's loop: consume, then stage."""
    got = []
    for t in range(n):
        vals, _ = pipe.consume(t)
        got.append(vals)
        pipe.stage(t)
    pipe.close()
    return got


def _rows(kind):
    if kind == "disjoint":
        return lambda it: {"rows": [np.array([it], dtype=np.int64)]}
    return lambda it: {"rows": [np.array([7], dtype=np.int64)]}


@pytest.mark.parametrize("kind,want", [
    ("disjoint", dict(overlapped=4, hazard_serialized=0)),
    ("colliding", dict(overlapped=0, hazard_serialized=4)),
])
def test_stream_overlaps_or_serializes(kind, want):
    """A hazard-free stream serves every step after the first from a staged
    lookup; a stream that reads one row every step stages nothing."""
    pipe = StepPipeline(PipelineConfig(depth=2), 1, prepare=_rows(kind),
                        stage_fn=lambda s, it, prep, ctx: f"v{it}", end=5)
    got = _drive(pipe, 5)
    assert got[0] == [None]
    assert [g[0] for g in got[1:]] == (["v1", "v2", "v3", "v4"] if kind == "disjoint"
                                       else [None] * 4)
    st = pipe.stats
    assert (st.steps, st.shard_steps, st.worker_errors) == (5, 5, 0)
    assert (st.overlapped, st.hazard_serialized) == (want["overlapped"],
                                                    want["hazard_serialized"])
    assert st.overlap_rate == pytest.approx(want["overlapped"] / 5)
    assert pipe.error is None


def test_depth_one_is_serial_and_starts_no_worker():
    pipe = StepPipeline(PipelineConfig(depth=1), 2,
                        prepare=lambda it: {"rows": [np.array([it])] * 2},
                        stage_fn=lambda s, it, prep, ctx: "never")
    assert pipe._worker is None
    got = _drive(pipe, 3)
    assert all(g == [None, None] for g in got)
    st = pipe.stats
    assert (st.overlapped, st.hazard_serialized, st.shard_steps) == (0, 0, 6)


@pytest.mark.parametrize("cause", ["drain", "epoch"])
def test_staged_values_drop_on_drain_or_epoch(cause):
    """``drain()`` (the owner, before a membership epoch advances) drops both
    staged steps; an epoch that moved under a staged step drops it at
    consume."""
    epoch = [0]
    pipe = StepPipeline(PipelineConfig(depth=3), 1, prepare=lambda it: {"rows": [np.array([it])]},
                        stage_fn=lambda s, it, prep, ctx: f"v{it}", epoch=lambda: epoch[0])
    pipe.stage(0)  # stages steps 1 and 2
    if cause == "drain":
        pipe.drain()
    else:
        epoch[0] += 1
    vals, _ = pipe.consume(1)
    assert vals == [None]
    assert pipe.stats.drains == (2 if cause == "drain" else 1)
    assert pipe.stats.overlapped == 0
    pipe.close()


def test_shard_token_mismatch_drains_that_shard():
    tok = [0, 0]
    pipe = StepPipeline(PipelineConfig(depth=2), 2,
                        prepare=lambda it: {"rows": [np.array([it]), np.array([100 + it])]},
                        stage_fn=lambda s, it, prep, ctx: f"v{s}:{it}",
                        shard_token=lambda s: tok[s])
    pipe.stage(0)
    assert pipe._buf[1].done.wait(5.0)  # the stager published step 1
    tok[1] += 1  # PS 1 fails or recovers between staging and use
    vals, _ = pipe.consume(1)
    assert vals == ["v0:1", None]
    assert (pipe.stats.drains, pipe.stats.overlapped) == (1, 1)
    pipe.close()


def test_worker_error_degrades_to_serial():
    def boom(s, it, prep, ctx):
        raise ValueError("injected stage failure")

    pipe = StepPipeline(PipelineConfig(depth=2), 1, prepare=lambda it: {"rows": [np.array([it])]},
                        stage_fn=boom)
    got = _drive(pipe, 4)
    assert all(g == [None] for g in got)
    assert pipe.stats.worker_errors >= 1 and pipe.stats.overlapped == 0
    assert isinstance(pipe.error, ValueError)


def test_close_is_idempotent_and_stops_the_worker():
    pipe = StepPipeline(PipelineConfig(depth=2), 1, prepare=lambda it: {"rows": [np.array([it])]},
                        stage_fn=lambda s, it, prep, ctx: it)
    worker = pipe._worker
    assert worker is not None and worker.is_alive()
    pipe.close()
    pipe.close()
    assert not worker.is_alive() and threading.active_count() >= 1


def test_make_ctx_is_captured_at_stage_time():
    """The context the stager receives is the one ``make_ctx`` returned on
    the owner's thread at ``stage`` (the runners' fence event)."""
    seen = []
    stamp = iter(range(100))
    pipe = StepPipeline(PipelineConfig(depth=2), 1, prepare=lambda it: {"rows": [np.array([it])]},
                        stage_fn=lambda s, it, prep, ctx: seen.append((it, ctx)) or it,
                        make_ctx=lambda: (threading.get_ident(), next(stamp)), end=3)
    _drive(pipe, 3)
    owner = threading.get_ident()
    assert seen == [(1, (owner, 0)), (2, (owner, 1))]


@pytest.mark.parametrize("kind", ["disjoint", "colliding"])
def test_stats_match_the_jax_pipeline_on_one_stream(kind):
    """The port's state machine and the JAX package's count the same steps
    on the same synthetic stream."""
    stats = []
    for cls, cfg in ((StepPipeline, PipelineConfig), (jpipeline.StepPipeline,
                                                       jpipeline.PipelineConfig)):
        pipe = cls(cfg(depth=3), 1, prepare=_rows(kind), stage_fn=lambda s, it, prep, ctx: it,
                   end=8)
        _drive(pipe, 8)
        stats.append(pipe.stats.as_dict())
    assert stats[0] == stats[1]


# ---------------------------------------------------------------------------
# HogwildSim: pipelined == serial, bitwise
# ---------------------------------------------------------------------------

def _sim(pipeline, cfg=BIG, cache=None, engine="flat", seed=0, **kw):
    return runners.HogwildSim(cfg, sync.SyncConfig(algo="easgd", mode="shadow", gap=5,
                                                   engine=engine),
                              n_trainers=2, n_threads=1, batch_size=4,
                              optimizer=optim.adagrad(0.02), seed=seed, cache=cache,
                              pipeline=pipeline, device="cpu", **kw)


def _bitwise(out_s, out_p):
    assert out_s["train_loss"] == out_p["train_loss"]
    for k in ("table", "acc"):
        assert torch.equal(out_s["state"].emb_state[k], out_p["state"].emb_state[k]), k
    for a, b in zip(T.leaves(out_s["state"].w_stack), T.leaves(out_p["state"].w_stack)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_sim_pipelined_is_bitwise_serial(engine, depth, cached):
    cache = CacheConfig(**CACHE) if cached else None
    # the serial run prefetches over the pipelined run's horizon
    cache_s = (dataclasses.replace(cache, lookahead=cache.effective_lookahead(depth))
               if cached else None)
    out_s = _sim(None, cache=cache_s, engine=engine).run(12)
    out_p = _sim(PipelineConfig(depth=depth), cache=cache, engine=engine).run(12)
    _bitwise(out_s, out_p)
    ps = out_p["pipeline_stats"]
    assert ps["overlapped"] > 0 and ps["worker_errors"] == 0, ps
    assert ps["steps"] == ps["shard_steps"] == 12
    assert "pipeline_stats" not in out_s
    if cached:
        # the staged lookups went through the store's staged entry point,
        # and placement stayed invisible: the step that consumes a staged
        # lookup takes its frequency count, so the decayed-LFU victims and
        # every other counter are the serial run's
        assert out_p["cache_stats"].pop("staged_lookups") == ps["overlapped"]
        assert out_s["cache_stats"].pop("staged_lookups") == 0
        assert out_s["cache_stats"] == out_p["cache_stats"]
        assert out_p["cache_stats"]["evict_rows"] > 0


def test_a_staged_lookup_is_counted_by_the_step_that_consumes_it():
    """``CachedStore``: a staged lookup leaves its frequency count to
    ``count``, which the consuming step takes after the boundary's prefetch
    has aged the counts, as the serial loop counts; the decayed-LFU state is
    then the serial one's exactly, whatever ran on the stager meanwhile."""
    gen = torch.Generator().manual_seed(0)
    state = {"table": torch.randn((2000, 8), generator=gen), "acc": torch.zeros(2000, 8)}
    idx = np.random.default_rng(0).integers(0, 2000, (32, 2))
    serial, piped = (CachedStore({k: v.clone() for k, v in state.items()},
                                 CacheConfig(hot_rows=256, lookahead=2)) for _ in range(2))
    for store in (serial, piped):
        store.lookup(idx[:16])
    serial.prefetch([idx[16:]])  # the boundary, then the step's lookup
    out_s = serial.lookup(idx[16:])
    out_p = piped.lookup(idx[16:], staged=True)  # staged before the boundary
    piped.prefetch([idx[16:]])
    piped.count(idx[16:])  # the step that consumes it
    assert torch.equal(out_s, out_p)
    np.testing.assert_array_equal(serial.freq, piped.freq)
    assert (serial.stats.staged_lookups, piped.stats.staged_lookups) == (0, 1)


def test_sim_every_step_hazards_and_stays_bitwise():
    out_s = _sim(None, cfg=ONE).run(8)
    out_p = _sim(PipelineConfig(depth=2), cfg=ONE).run(8)
    _bitwise(out_s, out_p)
    ps = out_p["pipeline_stats"]
    assert ps["overlapped"] == 0 and ps["hazard_serialized"] == 7


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_sim_elastic_events_drain_and_stay_bitwise(cached):
    cache = CacheConfig(**CACHE) if cached else None
    sched = [(4, "fail", 1), (8, "join", 1)]
    out_s = _sim(None, cache=cache, schedule=sched, seed=3).run(12)
    out_p = _sim(PipelineConfig(depth=2), cache=cache, schedule=sched, seed=3).run(12)
    assert np.array_equal(out_s["replica_losses"], out_p["replica_losses"])
    _bitwise({**out_s, "train_loss": 0}, {**out_p, "train_loss": 0})
    ps = out_p["pipeline_stats"]
    assert ps["drains"] == 2 and ps["overlapped"] > 0, ps


def test_sim_mode_handoff_drains_and_stays_bitwise():
    msched = [(3, "fixed_rate"), (8, "shadow")]
    out_s = _sim(None, mode_schedule=msched).run(12)
    out_p = _sim(PipelineConfig(depth=2), mode_schedule=msched).run(12)
    _bitwise(out_s, out_p)
    assert out_s["mode_events"] == out_p["mode_events"] == [(3, "shadow", "fixed_rate"),
                                                            (8, "fixed_rate", "shadow")]
    assert out_p["pipeline_stats"]["drains"] == 2


def test_sim_resumed_pipelined_run_is_bitwise_serial():
    sim_s, sim_p = _sim(None, seed=4), _sim(PipelineConfig(depth=2), seed=4)
    out_s = sim_s.run(3, state=sim_s.run(4)["state"])
    out_p = sim_p.run(3, state=sim_p.run(4)["state"])
    assert out_p["state"].step == 7
    _bitwise(out_s, out_p)


def test_pipeline_stats_keys():
    ps = _sim(PipelineConfig(depth=2)).run(6)["pipeline_stats"]
    assert set(ps) == {"steps", "shard_steps", "overlapped", "hazard_serialized", "drains",
                       "worker_errors", "overlap_rate"}
    assert PipelineStats(**{k: v for k, v in ps.items() if k != "overlap_rate"}).as_dict() == ps


# ---------------------------------------------------------------------------
# ThreadedShadowRunner
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_threaded_one_trainer_pipelined_is_bitwise_serial(cached):
    """One trainer, fixed_rate, no supervisor: deterministic, so the packed
    tables and the replica of the pipelined run are the serial run's."""
    outs = []
    for p in (None, PipelineConfig(depth=2)):
        r = runners.ThreadedShadowRunner(
            BIG, sync.SyncConfig(mode="fixed_rate", gap=4), n_trainers=1, batch_size=8,
            optimizer=optim.adagrad(0.02), n_emb_shards=4, supervise=False,
            cache=CacheConfig(**CACHE) if cached else None, pipeline=p, device="cpu")
        outs.append(r.run(12))
    s, p = outs
    assert s["train_loss"] == p["train_loss"] and s["sync_count"] == p["sync_count"] == 3
    for k in ("table", "acc"):
        assert torch.equal(s["emb_state"][k], p["emb_state"][k]), k
    for a, b in zip(T.leaves(s["w"][0]), T.leaves(p["w"][0])):
        assert torch.equal(a, b)
    ps = p["pipeline_stats"]
    assert ps["steps"] == 12 and ps["shard_steps"] == 48 and ps["worker_errors"] == 0
    assert ps["overlapped"] > 0, ps
    assert s["pipeline_stats"] == {}
    if cached:
        assert p["cache_stats"]["staged_lookups"] == ps["overlapped"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_threaded_pipelined_run(cached):
    r = runners.ThreadedShadowRunner(
        BIG, sync.SyncConfig(algo="easgd", gap=4), n_trainers=2, batch_size=4,
        optimizer=optim.adagrad(0.02), seed=2, sync_sleep_s=0.005,
        cache=CacheConfig(**CACHE) if cached else None, pipeline=PipelineConfig(depth=2),
        device="cpu")
    out = r.run(10)
    assert out["iter_count"] == [10, 10] and all(np.isfinite(out["train_loss"]))
    ps = out["pipeline_stats"]
    assert ps["steps"] == 20 and ps["shard_steps"] == 20 * r.n_emb_shards
    assert ps["worker_errors"] == 0 and ps["overlapped"] > 0, ps
    assert torch.isfinite(out["emb_state"]["table"]).all()
    assert all(p is not None and p._worker is None for p in r._pipes)  # every stager stopped


@pytest.mark.timeout(120)
def test_threaded_pipelined_ps_fail_completes():
    """A PS dying mid-run bumps its incarnation: staged lookups against it
    drain, and the run completes with canonical packed tables."""
    fault = FaultSpec(ps_fail_at={0: 2}, ps_recover_after_s=0.1,
                      straggler_sleep_s={0: 0.01, 1: 0.01})
    r = runners.ThreadedShadowRunner(
        BIG, sync.SyncConfig(algo="easgd", gap=4), n_trainers=2, batch_size=4,
        optimizer=optim.adagrad(0.02), seed=2, fault_spec=fault,
        cache=CacheConfig(**CACHE), pipeline=PipelineConfig(depth=2), device="cpu")
    out = r.run(20)
    kinds = [e.kind for e in out["shard_events"]]
    assert "ps_fail" in kinds and "ps_recover" in kinds
    assert out["pipeline_stats"]["worker_errors"] == 0
    assert out["iter_count"] == [20, 20] and all(np.isfinite(out["train_loss"]))
    assert r.emb.incarnation(0) == 2


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_stream(monkeypatch):
    """The port's batches and peeks from the JAX package's stream."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})
    monkeypatch.setattr(ctr, "sparse_ids", lambda cfg, seed, i, n: np.array(
        jctr.gen_batch(cfg, jctr.make_teacher(cfg), seed, i, n)["sparse"]))


JAX_ITERS = 10
JAX_SCHED = ((4, "fail", 1), (7, "join", 1))


@functools.lru_cache(maxsize=None)
def _jax_pipelined(engine, depth, cached, elastic):
    sim = jrunners.HogwildSim(
        BIG, jsync.SyncConfig(algo="easgd", mode="shadow", gap=5, engine=engine),
        n_trainers=2, n_threads=1, batch_size=4, optimizer=joptim.adagrad(0.02), seed=0,
        cache=jcache.CacheConfig(**CACHE) if cached else None,
        pipeline=jpipeline.PipelineConfig(depth=depth),
        schedule=list(JAX_SCHED) if elastic else None)
    st0 = sim.init_state()
    init = tuple(jax.tree.map(np.array, x) for x in (st0.w_stack, st0.opt_stack, st0.emb_state,
                                                     st0.algo_state))
    out = sim.run(JAX_ITERS, state=st0)
    st = out["state"]
    return (init, out["train_loss"], out["pipeline_stats"],
            {k: np.array(v) for k, v in st.emb_state.items()},
            jax.tree.map(np.array, st.w_stack), out.get("replica_losses"))


@pytest.mark.parametrize("engine,depth,cached,elastic", [
    ("flat", 2, False, False), ("pytree", 2, False, False), ("flat", 3, False, False),
    ("flat", 2, True, False), ("pytree", 3, True, False), ("flat", 2, False, True),
])
def test_pipelined_sim_follows_the_jax_pipelined_sim(jax_stream, engine, depth, cached, elastic):
    init, j_loss, j_stats, j_emb, j_w, j_rep = _jax_pipelined(engine, depth, cached, elastic)
    sim = _sim(PipelineConfig(depth=depth), engine=engine,
               cache=CacheConfig(**CACHE) if cached else None,
               schedule=list(JAX_SCHED) if elastic else None)
    out = sim.run(JAX_ITERS, state=interop.sim_state_from_numpy(*init, device="cpu"))
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    stats = out["pipeline_stats"]
    if not elastic:
        assert stats == j_stats
    else:
        # A membership drain discards the staged entries (one a drained
        # step at depth 2, each of the sim's one lookup unit); the worker
        # skips a discarded job it has not started, uncounted, and counts
        # the hazards of one it already ran (core/pipeline.py::_worker_loop,
        # the same in the JAX package). So each package's hazard_serialized
        # lies in [H - drains, H], H the count with every job run, and the
        # two differ by at most the drains; every other key is exact.
        assert {k: v for k, v in stats.items() if k != "hazard_serialized"} == \
            {k: v for k, v in j_stats.items() if k != "hazard_serialized"}
        assert j_stats["drains"] > 0
        assert abs(stats["hazard_serialized"] - j_stats["hazard_serialized"]) <= j_stats["drains"]
    assert j_stats["overlapped"] > 0
    for k in ("table", "acc"):
        np.testing.assert_allclose(out["state"].emb_state[k].numpy(), j_emb[k], **TRAJ)
    for a, b in zip(T.leaves(out["state"].w_stack), jax.tree.leaves(j_w)):
        np.testing.assert_allclose(a.numpy(), b, **TRAJ)
    if elastic:
        np.testing.assert_allclose(out["replica_losses"], j_rep, **TRAJ)
