"""The port's tiered embedding cache (``repro_torch/embeddings/cache.py``).

* The store: ``CacheConfig`` validation, the routing invariants across a
  migration-heavy stream, the counted stall path at ``lookahead=0``, an
  eviction writing back a pending update, a hot tier too small, and the
  sparse-Adagrad wrapper's sort by row id (``order_ids``).
* Cached == uncached, bitwise, inside the port: the store's stream against
  the full-table kernels, cached shards against uncached, the sim on both
  engines, at lookahead 0 and under the elastic schedule, a resumed cached
  run, and a one-trainer fixed_rate threaded run.
* Composition: the cached-mode guards, a shard failing and recovering under
  the cache, the threaded runner with live prefetch, the store's gate under
  concurrent trainers and a prefetcher.
* Against the JAX package: the port's cached sim follows the JAX cached sim
  at the trajectory tolerance (the JAX batches fed to the port).
"""
import sys
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
from repro.embeddings import cache as jcache  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.core.supervision import SupervisorConfig  # noqa: E402
from repro_torch.data import ctr  # noqa: E402
from repro_torch.embeddings import shards  # noqa: E402
from repro_torch.embeddings import table as emb  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig, CachedStore, LookaheadPrefetcher  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op  # noqa: E402
from repro_torch.kernels.sparse_adagrad.ops import sort_occurrences, sparse_adagrad_op  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()


def _store(n=128, d=8, hot=32, lookahead=2, seed=0, **kw):
    r = np.random.default_rng(seed)
    state = {"table": torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)),
             "acc": torch.from_numpy(np.abs(r.standard_normal((n, d))).astype(np.float32) * 0.1)}
    full = {k: v.clone() for k, v in state.items()}  # the uncached twin
    return CachedStore(state, CacheConfig(hot_rows=hot, lookahead=lookahead, **kw)), full


def _zipf_batch(i, n, B=16, m=4):
    u = np.random.default_rng(i).random((B, m))
    return np.minimum((u * u * n).astype(np.int64), n - 1)  # a skewed stream


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("table", "acc"))


# ---------------------------------------------------------------------------
# CacheConfig
# ---------------------------------------------------------------------------

def test_config_exactly_one_budget_and_resolution():
    for bad in (CacheConfig(), CacheConfig(hot_rows=8, hot_frac=0.5)):
        with pytest.raises(ValueError, match="exactly one"):
            bad.validate()
    assert CacheConfig(hot_rows=8).validate().hot_rows == 8
    assert CacheConfig(hot_frac=0.25).resolve_hot_rows(1000) == 250
    assert CacheConfig(hot_rows=4000).resolve_hot_rows(1000) == 1000  # clamped
    assert CacheConfig(hot_frac=1e-9).resolve_hot_rows(1000) == 1  # floor
    assert CacheConfig(hot_rows=8, lookahead=0).effective_lookahead(3) == 0


@pytest.mark.parametrize("kw", [dict(hot_rows=0), dict(hot_frac=0.0), dict(hot_frac=1.5),
                                dict(hot_rows=4, lookahead=-1), dict(hot_rows=4, decay=0.0),
                                dict(hot_rows=4, update_retries=-1)])
def test_config_rejects_bad_values(kw):
    with pytest.raises(ValueError):
        CacheConfig(**kw).validate()
    with pytest.raises(ValueError):
        jcache.CacheConfig(**kw).validate()  # the same refusals as the JAX package


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def test_routing_invariants_across_migrations():
    store, _ = _store(n=96, hot=24, lookahead=1)
    store.check_invariants()
    for it in range(12):
        idx = _zipf_batch(it, 96, B=5)  # <= 20 rows a batch < 24 slots
        store.prefetch([np.unique(_zipf_batch(it + 1, 96, B=5))])
        store.check_invariants()
        store.lookup(idx)
        store.check_invariants()
        store.update(idx, torch.full((5, 8), 0.01), 0.05)
        store.check_invariants()
    r = store.state.routing
    hot_rows = np.flatnonzero(r.slot >= 0)
    assert len(hot_rows) <= store.hot_budget and r.version > 0
    assert np.array_equal(np.sort(r.hot_row[r.hot_row >= 0]), np.sort(hot_rows))


def test_hot_tier_too_small_is_a_config_error():
    store, full = _store(n=64, hot=4)
    with pytest.raises(ValueError, match="hot tier too small"):
        store.lookup(np.arange(16).reshape(1, 16))
    store.check_invariants()  # nothing was published
    assert _equal(store.merged(), full)


def test_stall_path_counted_at_zero_lookahead():
    store, full = _store(n=64, hot=16, lookahead=0)
    idx = np.asarray([[60, 61], [62, 63]])  # all cold under the initial placement
    assert torch.equal(store.lookup(idx), embedding_bag_op(full["table"], torch.from_numpy(idx)))
    assert store.stats.stall_lookups == 1 and store.stats.miss_rows == 4
    assert LookaheadPrefetcher(store, lambda j: np.asarray([0, 1])).step() == {"promoted": 0}


def test_eviction_writes_back_pending_updates():
    store, full = _store(n=64, hot=8, lookahead=1)
    hot0 = np.asarray([[0, 1, 2, 3]])
    g = torch.full((1, 8), 0.25)
    assert store.update(hot0, g, lr=0.1)
    store.prefetch([np.arange(40, 48)])  # eight cold rows push rows 0..3 out
    assert store.state.routing.slot[0] < 0
    sparse_adagrad_op(full["table"], full["acc"], torch.from_numpy(hot0), g, lr=0.1)
    assert _equal(store.merged(), full)
    assert store.stats.writeback_rows >= 4


def test_store_stream_bitwise_vs_full_table():
    """20 skewed batches of lookup + update through a quarter-size tier are
    bitwise the full-table kernel stream, with the prefetcher migrating."""
    n = 256
    store, full = _store(n=n, hot=n // 4, lookahead=2)
    r = np.random.default_rng(7)
    for it in range(20):
        idx = _zipf_batch(it, n)
        LookaheadPrefetcher(store, lambda j, it=it: _zipf_batch(it + j, n)).step()
        assert torch.equal(store.lookup(idx), embedding_bag_op(full["table"],
                                                               torch.from_numpy(idx))), it
        g = torch.from_numpy(r.standard_normal((idx.shape[0], 8)).astype(np.float32))
        sparse_adagrad_op(full["table"], full["acc"], torch.from_numpy(idx), g, lr=0.05)
        assert store.update(idx, g, 0.05)
        store.check_invariants()
    assert _equal(store.merged(), full)
    s = store.stats
    assert s.prefetch_rows > 0 and s.evict_rows > 0  # migration really ran
    assert s.hit_rows / (s.hit_rows + s.miss_rows) > 0.5


def test_sort_by_row_gives_the_uncached_runs_over_slots():
    """The wrapper's sort (run on any device): for a remap of rows to slots
    that is not monotone, sorting the slot ids by ROW id gives the uncached
    call's permutation, and the slot sequence of its sorted rows."""
    r = np.random.default_rng(3)
    rows = torch.from_numpy(_zipf_batch(5, 500, B=64, m=4))
    slot_of = torch.from_numpy(r.permutation(500))  # a random placement
    slots = slot_of[rows]
    want_rows, want_order = sort_occurrences(rows)
    got_slots, got_order = sort_occurrences(slots, order_ids=rows)
    assert torch.equal(got_order, want_order)
    assert torch.equal(got_slots, slot_of[want_rows.long()].to(torch.int32))
    naive_slots, naive_order = sort_occurrences(slots)
    assert not torch.equal(naive_order, want_order)  # the remap really reorders the runs
    assert torch.equal(naive_slots.sort().values, got_slots.sort().values)
    with pytest.raises(ValueError, match="order_ids"):
        sort_occurrences(slots, order_ids=rows.reshape(-1))


def test_gate_holds_under_concurrent_trainers_and_a_prefetcher():
    """Four writer threads on disjoint rows and a prefetcher that keeps
    migrating: every update lands exactly once, so the merged table is the
    sequential result (a lost or misplaced update would break it)."""
    n, d, per = 128, 8, 32
    store, full = _store(n=n, d=d, hot=48, lookahead=2)
    grads = {i: [torch.full((2, d), 0.01 * (i + 1) + 0.001 * k) for k in range(15)]
             for i in range(4)}
    ids = {i: [np.random.default_rng(100 * i + k).integers(i * per, (i + 1) * per, (2, 4))
               for k in range(15)] for i in range(4)}
    for i in range(4):
        for idx, g in zip(ids[i], grads[i]):
            sparse_adagrad_op(full["table"], full["acc"], torch.from_numpy(idx), g, lr=0.05)
    stop, errors = threading.Event(), []

    def writer(i):
        try:
            for idx, g in zip(ids[i], grads[i]):
                store.lookup(idx)
                store.update(idx, g, 0.05)
        except BaseException as e:  # surfaced below
            errors.append(e)
            raise

    def prefetcher():
        r = np.random.default_rng(9)
        while not stop.is_set():
            store.prefetch([r.integers(0, n, 24)])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = threading.Thread(target=prefetcher)
        ws = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
        pf.start()
        for t in ws:
            t.start()
        for t in ws:
            t.join(timeout=60)
        stop.set()
        pf.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not pf.is_alive() and not any(t.is_alive() for t in ws)
    store.check_invariants()
    assert store.stats.evict_rows > 0
    assert _equal(store.merged(), full)


# ---------------------------------------------------------------------------
# EmbeddingShards in cached mode
# ---------------------------------------------------------------------------

def _mk_shards(cache=None, seed=3, n_shards=3):
    plan = shards.plan_shards(emb.spec_from_config(CFG), n_shards, 64)
    return plan, shards.EmbeddingShards.init(plan, torch.Generator().manual_seed(seed),
                                             cache=cache)


def _batch(teacher, t, n=16):
    return ctr.gen_batch(CFG, teacher, 0, t, n)["sparse"]


def test_cached_shards_bitwise_vs_uncached():
    plan, un = _mk_shards()
    _, ca = _mk_shards(cache=CacheConfig(hot_frac=0.25, lookahead=2))
    teacher = ctr.make_teacher(CFG, seed=5)
    r = np.random.default_rng(11)
    for t in range(6):
        idx = _batch(teacher, t)
        for s in range(plan.n_shards):
            ca.stores[s].prefetch([shards._route_np(plan, s, _batch(teacher, t + j).numpy())
                                   for j in range(2)])
        assert torch.equal(un.lookup(idx), ca.cached_lookup(idx.numpy())), t
        g = torch.from_numpy(r.standard_normal((16, CFG.n_sparse_features,
                                                CFG.embedding_dim)).astype(np.float32))
        for s in range(plan.n_shards):
            assert un.try_update(s, lambda st, *a, s=s: shards.shard_update(plan, s, st, *a),
                                 idx, g, 0.05)
            assert ca.cached_update(s, idx.numpy(), g, 0.05)
            ca.stores[s].check_invariants()
    assert _equal(un.to_packed(), ca.to_packed())
    assert ca.cache_stats()["prefetch_rows"] > 0


def test_cached_mode_guards_the_uncached_hot_path():
    _, ca = _mk_shards(cache=CacheConfig(hot_frac=0.5))
    idx = torch.zeros((1, CFG.n_sparse_features, CFG.multi_hot), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="cached_lookup"):
        ca.lookup(idx)
    with pytest.raises(RuntimeError, match="cached_update"):
        ca.try_update(0, lambda st: st)
    _, un = _mk_shards()
    with pytest.raises(RuntimeError, match="cache="):
        un.cached_lookup(idx.numpy())
    with pytest.raises(RuntimeError, match="cache="):
        un.cached_update(0, idx.numpy(), torch.zeros((1, CFG.n_sparse_features,
                                                      CFG.embedding_dim)), 0.05)
    assert un.cache_stats() == {}


def test_cached_shards_fail_recover_composition():
    """A cached shard fails: lookups read its snapshot, updates drop after
    the retry ladder; recovery builds a new store from the snapshot, and
    the packed view is the snapshot's, bitwise."""
    plan, ca = _mk_shards(cache=CacheConfig(hot_frac=0.25, lookahead=1))
    teacher = ctr.make_teacher(CFG, seed=9)
    idx = _batch(teacher, 0).numpy()
    g = torch.full((16, CFG.n_sparse_features, CFG.embedding_dim), 0.01)
    for s in range(plan.n_shards):
        ca.cached_update(s, idx, g, 0.05)
    ca.snapshot_all()
    ref = ca.to_packed()
    ca.fail_shard(1, "chaos")
    assert ca.stores[1] is None
    assert torch.isfinite(ca.cached_lookup(idx)).all()
    assert ca.stale_lookups[1] >= 1
    assert not ca.cached_update(1, idx, g, 0.05) and ca.dropped_updates[1] >= 1
    ca.recover_shard(1)
    assert ca.stores[1] is not None
    assert _equal(ca.to_packed(), ref)
    ca.stores[1].check_invariants()
    assert ca.cached_update(1, idx, g, 0.05)


# ---------------------------------------------------------------------------
# HogwildSim: cached == uncached, bitwise
# ---------------------------------------------------------------------------

def _sim(cache, engine="flat", seed=1, **kw):
    return runners.HogwildSim(CFG, sync.SyncConfig(algo="easgd", gap=4, delay=1, engine=engine),
                              n_trainers=2, n_threads=2, batch_size=8,
                              optimizer=optim.adagrad(0.02), seed=seed, cache=cache,
                              device="cpu", **kw)


def _sims_bitwise(out_u, out_c):
    assert out_u["train_loss"] == out_c["train_loss"]
    assert _equal(out_u["state"].emb_state, out_c["state"].emb_state)
    for a, b in zip(T.leaves(out_u["state"].w_stack), T.leaves(out_c["state"].w_stack)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["flat", "pytree", "zero_lookahead", "elastic", "resumed"])
def test_sim_cached_trajectory_is_bitwise_uncached(case):
    if case in ("flat", "pytree"):
        out_u = _sim(None, case).run(8)
        out_c = _sim(CacheConfig(hot_frac=0.25, lookahead=2), case).run(8)
        cs = out_c["cache_stats"]
        assert cs["prefetch_rows"] > 0 and cs["evict_rows"] > 0 and cs["stall_lookups"] == 0
    elif case == "zero_lookahead":  # every cold row a synchronous promotion
        out_u = _sim(None).run(5)
        out_c = _sim(CacheConfig(hot_frac=0.3, lookahead=0)).run(5)
        assert out_c["cache_stats"]["stall_lookups"] > 0
    elif case == "elastic":
        sched = [(2, "leave", 1), (4, "join", 1)]
        out_u = _sim(None, schedule=sched, seed=6).run(6)
        out_c = _sim(CacheConfig(hot_frac=0.3, lookahead=1), schedule=sched, seed=6).run(6)
        assert np.array_equal(out_u["replica_losses"], out_c["replica_losses"])
    else:  # merged() hands back the canonical tables: a cached run resumes as uncached
        sim_u, sim_c = _sim(None, seed=4), _sim(CacheConfig(hot_frac=0.25, lookahead=1), seed=4)
        out_u = sim_u.run(3, state=sim_u.run(4)["state"])
        out_c = sim_c.run(3, state=sim_c.run(4)["state"])
        assert out_c["state"].step == 7
    _sims_bitwise(out_u, out_c)
    assert "cache_stats" not in out_u


# ---------------------------------------------------------------------------
# ThreadedShadowRunner
# ---------------------------------------------------------------------------

def test_threaded_one_trainer_cached_is_bitwise_uncached():
    """One trainer, fixed_rate, no supervisor: deterministic, so the packed
    tables and the replica are bitwise those of the uncached run."""
    outs = []
    for cache in (None, CacheConfig(hot_frac=0.25, lookahead=2)):
        r = runners.ThreadedShadowRunner(
            CFG, sync.SyncConfig(mode="fixed_rate", gap=4), n_trainers=1, batch_size=16,
            optimizer=optim.adagrad(0.02), n_emb_shards=3, supervise=False, cache=cache,
            device="cpu")
        outs.append(r.run(12))
    u, c = outs
    assert u["train_loss"] == c["train_loss"] and u["sync_count"] == c["sync_count"] == 3
    assert _equal(u["emb_state"], c["emb_state"])
    for a, b in zip(T.leaves(u["w"][0]), T.leaves(c["w"][0])):
        assert torch.equal(a, b)
    assert u["cache_stats"] == {} and c["cache_stats"]["lookups"] == 12 * 3


def _runner(cache, fault=None, **kw):
    sup = (SupervisorConfig(heartbeat_deadline_s=1.0, check_interval_s=0.01, backoff_s=0.05,
                            max_restarts=3) if fault is not None else None)
    return runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", gap=2), n_trainers=2, batch_size=16,
        optimizer=optim.adagrad(0.02), seed=2, cache=cache, fault_spec=fault,
        supervisor_config=sup, device="cpu", **kw)


@pytest.mark.parametrize("fault", [None, FaultSpec(ps_fail_at={0: 2}, ps_recover_after_s=0.2)])
def test_threaded_cached_run(fault):
    """Two trainers with live prefetch (and a PS that fails and recovers)
    finish with canonical packed tables."""
    r = _runner(CacheConfig(hot_frac=0.3, lookahead=2), fault=fault)
    r.warmup()
    out = r.run(8)
    assert out["iter_count"] == [8, 8] and all(np.isfinite(out["train_loss"]))
    assert out["cache_stats"]["lookups"] > 0 and out["cache_stats"]["prefetch_rows"] > 0
    packed = out["emb_state"]
    assert packed["table"].shape == (CFG.n_embedding_rows, CFG.embedding_dim)
    assert torch.isfinite(packed["table"]).all()
    if fault is None:
        assert out["dropped_updates"] == [0] * r.n_emb_shards
    else:
        kinds = [e.kind for e in out["shard_events"]]
        assert "ps_fail" in kinds and "ps_recover" in kinds
    for store in r.emb.stores:
        store.check_invariants()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_stream(monkeypatch):
    """The port's batches and peeks from the JAX package's stream (the
    sparse ids do not depend on the teacher)."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})
    monkeypatch.setattr(ctr, "sparse_ids", lambda cfg, seed, i, n: np.array(
        jctr.gen_batch(cfg, jctr.make_teacher(cfg), seed, i, n)["sparse"]))


def test_port_cached_sim_follows_the_jax_cached_sim(jax_stream):
    kw = dict(n_trainers=2, n_threads=2, batch_size=8, seed=1)
    cache = dict(hot_frac=0.25, lookahead=2)
    jsim = jrunners.HogwildSim(jcfg.tiny(), jsync.SyncConfig(gap=4, delay=1),
                               optimizer=joptim.adagrad(0.02), cache=jcache.CacheConfig(**cache),
                               **kw)
    st0 = jsim.init_state()
    init = [jax.tree.map(np.array, x) for x in (st0.w_stack, st0.opt_stack, st0.emb_state,
                                                st0.algo_state)]
    j_out = jsim.run(8, state=st0)
    sim = runners.HogwildSim(CFG, sync.SyncConfig(gap=4, delay=1), optimizer=optim.adagrad(0.02),
                             cache=CacheConfig(**cache), device="cpu", **kw)
    out = sim.run(8, state=interop.sim_state_from_numpy(*init, device="cpu"))
    np.testing.assert_allclose(out["train_loss"], j_out["train_loss"], **TRAJ)
    for k in ("table", "acc"):
        np.testing.assert_allclose(out["state"].emb_state[k].numpy(),
                                   np.asarray(j_out["state"].emb_state[k]), **TRAJ)
    assert out["cache_stats"]["stall_lookups"] == j_out["cache_stats"]["stall_lookups"] == 0
