"""The port's plan-sharded embedding PSs against the JAX package's.

Inputs are made with numpy and handed to both; the JAX side runs its Pallas
kernels in interpret mode (the default off TPU). ``EmbeddingShards``' failure
domain is checked on the port alone: its in-place updates and copied
snapshots are where it differs from the reference by design.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.embeddings import shards as jshards  # noqa: E402
from repro.embeddings import table as jtable  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.embeddings import shards, table  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)  # the reference's kernel tolerance
D = 8


def _specs(sizes=(40, 30, 25, 12, 9, 5), dim=D, m=3):
    return jtable.TableSpec(tuple(sizes), dim, m), table.TableSpec(tuple(sizes), dim, m)


def _packed(rng, rows, dim=D):
    return {"table": rng.standard_normal((rows, dim)).astype(np.float32),
            "acc": rng.uniform(0.0, 1.0, (rows, dim)).astype(np.float32)}


def _idx(rng, spec, B):
    return np.stack([rng.integers(0, s, size=(B, spec.multi_hot)) for s in spec.sizes],
                    1).astype(np.int32)


@pytest.mark.parametrize("which", ["config", "tiny", "small"])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
@pytest.mark.parametrize("B", [16, 128])
def test_plan_equals_jax(which, n_shards, B):
    if which == "small":
        js, ts = _specs()
    else:
        jc, tc = (jcfg.CONFIG, dlrm_ctr.CONFIG) if which == "config" else (jcfg.tiny(), dlrm_ctr.tiny())
        js = jtable.TableSpec(tuple(jc.table_sizes), jc.embedding_dim, jc.multi_hot)
        ts = table.spec_from_config(tc)
    np.testing.assert_array_equal(table.lookup_costs(ts, B), jtable.lookup_costs(js, B))
    costs = table.lookup_costs(ts, B)
    assert table.bin_pack(costs, n_shards) == jtable.bin_pack(costs, n_shards)
    jp, tp = jshards.plan_shards(js, n_shards, B), shards.plan_shards(ts, n_shards, B)
    assert (tp.bins, tp.feature_shard, tp.feature_local_offset, tp.shard_rows) == \
        (jp.bins, jp.feature_shard, jp.feature_local_offset, jp.shard_rows)
    assert tp.feature_order == jp.feature_order and tp.n_shards == jp.n_shards


def test_config_plan_rows():
    """The full CONFIG plan at B=128 over 4 PSs."""
    plan = shards.plan_shards(table.spec_from_config(dlrm_ctr.CONFIG), 4, 128)
    assert plan.shard_rows == (4_002_200, 2_115_100, 1_392_500, 1_375_000)
    assert sum(plan.shard_rows) == dlrm_ctr.CONFIG.n_embedding_rows


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_states_round_trip_and_match_jax(n_shards):
    js, ts = _specs()
    rng = np.random.default_rng(n_shards)
    packed = _packed(rng, sum(ts.sizes))
    plan = shards.plan_shards(ts, n_shards, 16)
    jplan = jshards.plan_shards(js, n_shards, 16)
    got = interop.shard_states_from_numpy(plan, packed)
    want = jshards.shard_states(jplan, {k: jnp.asarray(v) for k, v in packed.items()})
    assert len(got) == plan.n_shards
    for g, w in zip(got, want):
        for k in ("table", "acc"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    back = shards.packed_state(plan, got)
    for k in ("table", "acc"):
        np.testing.assert_array_equal(back[k].numpy(), packed[k])


def _lookup_update_inputs(seed, n_shards, B=9):
    js, ts = _specs()
    rng = np.random.default_rng(seed)
    packed = _packed(rng, sum(ts.sizes))
    idx = _idx(rng, ts, B)
    g = rng.standard_normal((B, len(ts.sizes), D)).astype(np.float32)
    return js, ts, packed, idx, g, jshards.plan_shards(js, n_shards, B), \
        shards.plan_shards(ts, n_shards, B)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_lookup_matches_jax(n_shards):
    js, ts, packed, idx, _, jplan, plan = _lookup_update_inputs(n_shards, n_shards)
    j_states = jshards.shard_states(jplan, {k: jnp.asarray(v) for k, v in packed.items()})
    want = jshards.shard_lookup(jplan, tuple(s["table"] for s in j_states), jnp.asarray(idx))
    states = interop.shard_states_from_numpy(plan, packed)
    got = shards.shard_lookup(plan, tuple(s["table"] for s in states), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the single packed table gives the same pooled rows
    ref = table.lookup_ref({k: torch.from_numpy(v) for k, v in packed.items()}, ts,
                           torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("lr", [0.05, 0.5])
def test_shard_update_matches_jax(n_shards, lr):
    js, ts, packed, idx, g, jplan, plan = _lookup_update_inputs(10 + n_shards, n_shards)
    j_states = jshards.shard_states(jplan, {k: jnp.asarray(v) for k, v in packed.items()})
    states = interop.shard_states_from_numpy(plan, packed)
    for s in range(plan.n_shards):
        want = jshards.shard_update(jplan, s, j_states[s], jnp.asarray(idx), jnp.asarray(g), lr)
        tab, acc = states[s]["table"], states[s]["acc"]
        got = shards.shard_update(plan, s, states[s], torch.from_numpy(idx), torch.from_numpy(g), lr)
        assert got["table"] is tab and got["acc"] is acc  # in place
        for k in ("table", "acc"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


# ---------------------------------------------------------------------------
# EmbeddingShards: the failure domain (port only)
# ---------------------------------------------------------------------------

FAST = shards.ShardRetryPolicy(retries=2, backoff_s=0.0005, timeout_s=0.01)


def _holder(seed=0, n_shards=3):
    _, ts, packed, idx, g, _, plan = _lookup_update_inputs(seed, n_shards)
    embs = shards.EmbeddingShards(plan, interop.shard_states_from_numpy(plan, packed), retry=FAST)
    upd = [lambda st, i, gg, s=s: shards.shard_update(plan, s, st, i, gg, 0.05)
           for s in range(plan.n_shards)]
    return embs, plan, packed, torch.from_numpy(idx), torch.from_numpy(g), upd


def test_holder_lookup_update_and_to_packed_match_oracle():
    embs, plan, packed, idx, g, upd = _holder()
    t = {k: torch.from_numpy(v) for k, v in packed.items()}
    np.testing.assert_allclose(embs.lookup(idx).numpy(), table.lookup_ref(t, plan.spec, idx).numpy(),
                               **TOL)
    assert all(embs.try_update(s, upd[s], idx, g) for s in range(plan.n_shards))
    want = table.sparse_adagrad_update(t, plan.spec, idx, g, 0.05)
    got = embs.to_packed()
    for k in ("table", "acc"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL)
    assert embs.stale_lookups == [0] * 3 and embs.dropped_updates == [0] * 3


def test_fail_serves_snapshot_drops_updates_then_recovers():
    embs, plan, packed, idx, g, upd = _holder(1)
    embs.try_update(0, upd[0], idx, g)
    embs.snapshot_all()
    snap_table = embs.states[0]["table"].clone()
    embs.try_update(0, upd[0], idx, g)  # after the snapshot: lost with the PS
    lost = embs.states[0]["table"].clone()
    assert not torch.equal(lost, snap_table)
    embs.fail_shard(0, reason="test")
    assert embs.down_shards() == [0] and embs.incarnations[0] == 1
    pooled = embs.lookup(idx)  # shard 0 answers from its snapshot
    assert embs.stale_lookups == [1, 0, 0]
    want = shards.shard_lookup(plan, (snap_table, embs.states[1]["table"],
                                      embs.states[2]["table"]), idx)
    torch.testing.assert_close(pooled, want, rtol=0, atol=0)
    assert embs.try_update(0, upd[0], idx, g) is False  # retried, then dropped
    assert embs.dropped_updates == [1, 0, 0]
    assert embs.try_update(1, upd[1], idx, g) is True  # the others never wait
    embs.recover_shard(0, reason="test")
    assert embs.down_shards() == [] and embs.incarnations[0] == 2
    torch.testing.assert_close(embs.states[0]["table"], snap_table, rtol=0, atol=0)
    assert [e.kind for e in embs.events] == ["ps_fail", "ps_recover"]


def test_recovered_shard_does_not_alias_its_snapshot():
    """Recovery copies the snapshot into the live tensors: a later in-place
    update moves the live table and leaves the snapshot where it was."""
    embs, plan, packed, idx, g, upd = _holder(2)
    embs.snapshot_all()
    embs.fail_shard(0)
    embs.recover_shard(0)
    snap = embs.snapshots[0].value
    before = snap["table"].clone()
    assert snap["table"].data_ptr() != embs.states[0]["table"].data_ptr()
    assert embs.try_update(0, upd[0], idx, g)
    assert not torch.equal(embs.states[0]["table"], before)
    torch.testing.assert_close(snap["table"], before, rtol=0, atol=0)


def test_snapshots_alternate_between_two_buffers():
    """A new snapshot goes to the spare buffer, so the published one stays
    complete; a shard that is down keeps its last snapshot."""
    embs, plan, packed, idx, g, upd = _holder(3)
    first = embs.snapshots[0].value["table"]
    embs.snapshot_all()
    second = embs.snapshots[0].value["table"]
    assert second.data_ptr() != first.data_ptr()
    embs.snapshot_all()
    assert embs.snapshots[0].value["table"].data_ptr() == first.data_ptr()
    embs.fail_shard(1)
    held = embs.snapshots[1]
    embs.snapshot_all()
    assert embs.snapshots[1] is held and embs.snapshots[0].value["table"].data_ptr() == \
        second.data_ptr()


def test_to_packed_of_a_down_shard_is_its_snapshot():
    embs, plan, packed, idx, g, upd = _holder(4)
    embs.fail_shard(2)
    np.testing.assert_array_equal(embs.to_packed()["table"].numpy(), packed["table"])


def test_holder_refuses_the_cache():
    """The cache is ported now: a cached holder refuses the uncached hot
    path instead (tests/test_torch_cache.py holds the cached one)."""
    _, _, _, _, _, _, plan = _lookup_update_inputs(0, 2)
    embs = shards.EmbeddingShards.init(plan, torch.Generator().manual_seed(0),
                                       cache=CacheConfig(hot_frac=0.5))
    idx = torch.zeros((1, len(plan.spec.sizes), plan.spec.multi_hot), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="cached_lookup"):
        embs.lookup(idx)
    with pytest.raises(RuntimeError, match="cached_update"):
        embs.try_update(0, lambda st: st)
