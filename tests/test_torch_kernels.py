"""The port's kernel wrappers and plain versions against the JAX package's.

On the CPU a wrapper takes its plain PyTorch version; the JAX side runs its
Pallas kernels through ``*_op`` in interpret mode (the default off TPU) and its
``ref`` oracles. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.embeddings import table as jtable  # noqa: E402
from repro.kernels.easgd_update.ops import easgd_round_op as j_easgd_round_op  # noqa: E402
from repro.kernels.easgd_update.ref import easgd_round_ref as j_easgd_round_ref  # noqa: E402
from repro.kernels.embedding_bag.ops import embedding_bag_op as j_embedding_bag_op  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_embedding_bag_ref  # noqa: E402
from repro.kernels.sparse_adagrad.ops import sparse_adagrad_op as j_sparse_adagrad_op  # noqa: E402
from repro.kernels.sparse_adagrad.ref import sparse_adagrad_ref as j_sparse_adagrad_ref  # noqa: E402
from repro_torch.embeddings import table as ttable  # noqa: E402
from repro_torch.kernels.easgd_update.ops import easgd_round_op  # noqa: E402
from repro_torch.kernels.easgd_update.ref import easgd_round_ref  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op  # noqa: E402
from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref  # noqa: E402

# The reference's kernel tolerance (tests/test_flatspace.py:23): fp32 sums
# taken in another order differ by a few ulp.
TOL = dict(rtol=1e-5, atol=1e-6)
N_ROWS, D = 64, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _ids(rng, n_bags, m, n_rows=N_ROWS):
    """Ids that repeat within a bag and across bags: drawn from a few rows."""
    idx = rng.integers(0, n_rows // 4, size=(n_bags, m)).astype(np.int32)
    idx[0, :] = 3  # one bag that names the same row m times
    return idx


# ---------------------------------------------------------------------------
# K1 · embedding bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bags,m", [(1, 1), (7, 3), (33, 4), (128, 2)])
def test_embedding_bag_matches_jax(n_bags, m):
    rng = np.random.default_rng(n_bags * 10 + m)
    table = rng.standard_normal((N_ROWS, D)).astype(np.float32)
    idx = _ids(rng, n_bags, m)
    want_op = np.asarray(j_embedding_bag_op(jnp.asarray(table), jnp.asarray(idx)))
    want_ref = np.asarray(j_embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_allclose(embedding_bag_op(_t(table), _t(idx)).numpy(), want_op, **TOL)
    np.testing.assert_allclose(embedding_bag_ref(_t(table), _t(idx)).numpy(), want_ref, **TOL)


def test_embedding_bag_keeps_bag_dims():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((N_ROWS, D)).astype(np.float32)
    idx = rng.integers(0, N_ROWS, size=(3, 5, 2)).astype(np.int32)
    want = np.asarray(j_embedding_bag_op(jnp.asarray(table), jnp.asarray(idx)))
    got = embedding_bag_op(_t(table), _t(idx))
    assert got.shape == (3, 5, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# K2 · sparse Adagrad
# ---------------------------------------------------------------------------

def _adagrad_inputs(seed, n_bags, m):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N_ROWS, D)).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (N_ROWS, D)).astype(np.float32)
    idx = _ids(rng, n_bags, m)
    g = rng.standard_normal((n_bags, D)).astype(np.float32)
    return table, acc, idx, g


@pytest.mark.parametrize("n_bags,m", [(1, 1), (7, 3), (33, 4), (128, 2)])
@pytest.mark.parametrize("lr", [0.05, 0.5])
def test_sparse_adagrad_matches_jax(n_bags, m, lr):
    table, acc, idx, g = _adagrad_inputs(n_bags + m, n_bags, m)
    j_t, j_a = j_sparse_adagrad_op(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx),
                                   jnp.asarray(g), lr=lr)
    r_t, r_a = j_sparse_adagrad_ref(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx),
                                    jnp.asarray(g), lr)
    tt, ta = _t(table), _t(acc)
    out_t, out_a = sparse_adagrad_op(tt, ta, _t(idx), _t(g), lr=lr)
    assert out_t is tt and out_a is ta  # in place, as the TPU kernel aliases them
    np.testing.assert_allclose(out_t.numpy(), np.asarray(j_t), **TOL)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(j_a), **TOL)
    p_t, p_a = sparse_adagrad_ref(_t(table), _t(acc), _t(idx), _t(g), lr)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(r_t), **TOL)
    np.testing.assert_allclose(p_a.numpy(), np.asarray(r_a), **TOL)


def test_sparse_adagrad_untouched_rows_bit_identical():
    table, acc, idx, g = _adagrad_inputs(5, 40, 3)
    tt, ta = _t(table), _t(acc)
    sparse_adagrad_op(tt, ta, _t(idx), _t(g), lr=0.05)
    untouched = np.setdiff1d(np.arange(N_ROWS), idx)
    assert untouched.size > 0
    assert np.array_equal(tt.numpy()[untouched], table[untouched])
    assert np.array_equal(ta.numpy()[untouched], acc[untouched])
    touched = np.unique(idx)
    assert not np.array_equal(tt.numpy()[touched], table[touched])


# The CUDA kernel's summation order (csrc/sparse_adagrad.cu): the stable-
# sorted occurrences cut into tiles of K2_TILE positions; a run inside a tile
# sums acc[r] + g^2 in order; a run that crosses tiles leaves one partial a
# tile (from zero), and the tile where it begins adds them to acc[r] in tile
# order, in contiguous chunks: 32 / lanes of them (one warp) for a run that
# ends within the next 32 tiles, K2_COMBINE_THREADS / lanes (the block) else.
K2_TILE, K2_COMBINE_THREADS = 32, 512


def _tiled_adagrad(table, acc, idx, g, lr, eps=1e-8):
    """The kernels' arithmetic in float32 numpy, in their order. Returns
    (table, acc, the longest run)."""
    table, acc = table.copy(), acc.copy()
    n_rows, d = table.shape
    m = idx.shape[1]
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rows, bags = flat[order], order // m
    n = rows.size
    n_tiles = -(-n // K2_TILE)
    zero = np.zeros(d, np.float32)
    partial = {}

    def apply(r, a, s):
        acc[r] = a
        table[r] = table[r] - np.float32(lr) * (np.float32(1) / np.sqrt(a + np.float32(eps))) * s

    longest = 0
    for t in range(n_tiles):
        lo, hi = t * K2_TILE, min((t + 1) * K2_TILE, n)
        s_in = lo > 0 and rows[lo - 1] == rows[lo]
        s_out = hi < n and rows[hi] == rows[hi - 1]
        p = lo
        while p < hi:
            r, e = rows[p], p
            while e < hi and rows[e] == r:
                e += 1
            first, last = p == lo and s_in, e == hi and s_out
            finish = not (first or last)
            a, s = (acc[r].copy() if finish else zero.copy()), zero.copy()
            for j in range(p, e):
                x = g[bags[j]]
                a, s = a + x * x, s + x
            if finish:
                apply(r, a, s)
            else:
                partial[t, 0 if first else 1] = (a, s)
            p = e
    lanes = min(d // 4, 32)
    for t in range(n_tiles - 1):
        lo, hi = t * K2_TILE, (t + 1) * K2_TILE
        r = rows[hi - 1]
        if rows[hi] != r or (lo > 0 and rows[lo] == r and rows[lo - 1] == r):
            continue
        end = t + 1
        while (end + 1) * K2_TILE < n and rows[(end + 1) * K2_TILE] == r:
            end += 1
        parts = [partial[t, 1]] + [partial[k, 0] for k in range(t + 1, end + 1)]
        chunks = (32 if end - t <= 32 else K2_COMBINE_THREADS) // lanes
        per = -(-len(parts) // chunks)
        a, s = acc[r].copy(), zero.copy()
        for c in range(chunks):
            q_c, s_c = zero.copy(), zero.copy()
            for q, x in parts[c * per:(c + 1) * per]:
                q_c, s_c = q_c + q, s_c + x
            a, s = a + q_c, s + s_c
        apply(r, a, s)
    runs = np.diff(np.flatnonzero(np.r_[True, rows[1:] != rows[:-1], True]))
    return table, acc, int(runs.max())


def test_tile_order_constants_are_the_kernels():
    """The emulation's tile and combine-block sizes are the CUDA source's."""
    import re

    from repro_torch.kernels import backend as kbackend

    with open(kbackend.source_path("sparse_adagrad")) as f:
        src = f.read()
    found = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("TILE", "COMBINE_THREADS")}
    assert found == {"TILE": K2_TILE, "COMBINE_THREADS": K2_COMBINE_THREADS}


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("n_bags,m,hot", [(512, 4, False), (300, 3, False), (1024, 4, True)])
def test_sparse_adagrad_tile_order_matches_jax(n_bags, m, hot, d):
    """The tile-and-combine order stays within the CPU tolerance of the
    JAX kernel, on ids skewed as data/ctr.py skews them (a squared uniform
    over a 100-row table: row 0 takes ~10%, so runs cross many tiles); the
    hot case puts a quarter of the occurrences on row 0 besides."""
    rng = np.random.default_rng(n_bags + d)
    n_rows = 100
    u = rng.uniform(size=(n_bags, m))
    idx = np.minimum((u * u * n_rows).astype(np.int32), n_rows - 1)
    if hot:
        idx.reshape(-1)[rng.permutation(idx.size)[:idx.size // 4]] = 0
    table = rng.standard_normal((n_rows, d)).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (n_rows, d)).astype(np.float32)
    g = rng.standard_normal((n_bags, d)).astype(np.float32)
    t_t, t_a, longest = _tiled_adagrad(table, acc, idx, g, 0.05)
    assert longest > (33 if hot else 2) * K2_TILE  # runs across tiles; hot: the block's combine
    j_t, j_a = j_sparse_adagrad_op(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx),
                                   jnp.asarray(g), lr=0.05)
    np.testing.assert_allclose(t_t, np.asarray(j_t), **TOL)
    np.testing.assert_allclose(t_a, np.asarray(j_a), **TOL)
    p_t, p_a = sparse_adagrad_op(_t(table), _t(acc), _t(idx), _t(g), lr=0.05)
    np.testing.assert_allclose(t_t, p_t.numpy(), **TOL)
    np.testing.assert_allclose(t_a, p_a.numpy(), **TOL)
    untouched = np.setdiff1d(np.arange(n_rows), idx)
    assert np.array_equal(t_t[untouched], table[untouched])


def test_table_oracle_and_fused_match_jax():
    """embeddings/table.py: lookup, the out-of-place oracle and the fused
    in-place update, per-feature ids (B, F, m) with the packed offsets."""
    spec_j = jtable.TableSpec((20, 30, 14), D, 2)
    spec_t = ttable.TableSpec((20, 30, 14), D, 2)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, s, size=(9, 2)) for s in spec_j.sizes], 1).astype(np.int32)
    state = {"table": rng.standard_normal((64, D)).astype(np.float32),
             "acc": np.zeros((64, D), np.float32)}
    g = rng.standard_normal((9, 3, D)).astype(np.float32)
    j_state = {k: jnp.asarray(v) for k, v in state.items()}
    t_state = {k: _t(v) for k, v in state.items()}
    np.testing.assert_allclose(ttable.lookup(t_state, spec_t, _t(idx)).numpy(),
                               np.asarray(jtable.lookup(j_state, spec_j, jnp.asarray(idx))), **TOL)
    np.testing.assert_allclose(ttable.lookup_ref(t_state, spec_t, _t(idx)).numpy(),
                               np.asarray(jtable.lookup_ref(j_state, spec_j, jnp.asarray(idx))),
                               **TOL)
    want = jtable.sparse_adagrad_update(j_state, spec_j, jnp.asarray(idx), jnp.asarray(g), 0.05)
    oracle = ttable.sparse_adagrad_update(t_state, spec_t, _t(idx), _t(g), 0.05)
    fused = ttable.sparse_adagrad_update_fused(t_state, spec_t, _t(idx), _t(g), 0.05)
    for k in ("table", "acc"):
        np.testing.assert_allclose(oracle[k].numpy(), np.asarray(want[k]), **TOL)
        np.testing.assert_allclose(fused[k].numpy(), np.asarray(want[k]), **TOL)


# ---------------------------------------------------------------------------
# K3 · EASGD round
# ---------------------------------------------------------------------------

R, NR, LANE = 4, 256, 128


@pytest.mark.parametrize("fired", [[2], [0, 1, 2, 3], [3, 0, 2], [1, 3]])
@pytest.mark.parametrize("alpha", [0.5, 0.1])
def test_easgd_round_matches_jax(fired, alpha):
    rng = np.random.default_rng(len(fired))
    stack = rng.standard_normal((R, NR, LANE)).astype(np.float32)
    ps = rng.standard_normal((NR, LANE)).astype(np.float32)
    snap = rng.standard_normal((len(fired), NR, LANE)).astype(np.float32)
    f = np.asarray(fired, np.int32)
    j_stack, j_ps = j_easgd_round_op(jnp.asarray(stack), jnp.asarray(ps), jnp.asarray(snap),
                                     jnp.asarray(f), alpha)
    r_stack, r_ps = j_easgd_round_ref(jnp.asarray(stack), jnp.asarray(ps), jnp.asarray(snap),
                                      jnp.asarray(f), alpha)
    ts, tp = _t(stack), _t(ps)
    out_s, out_p = easgd_round_op(ts, tp, _t(snap), _t(f), alpha)
    assert out_s is ts and out_p is tp  # in place
    np.testing.assert_allclose(out_s.numpy(), np.asarray(j_stack), **TOL)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(j_ps), **TOL)
    p_s, p_p = easgd_round_ref(_t(stack), _t(ps), _t(snap), _t(f), alpha)
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_stack), **TOL)
    np.testing.assert_allclose(p_p.numpy(), np.asarray(r_ps), **TOL)
    for i in sorted(set(range(R)) - set(fired)):  # un-fired replicas untouched
        assert np.array_equal(out_s[i].numpy(), stack[i])


def test_cpu_wrappers_do_not_count_launches():
    """The counters count kernel launches only; the CPU path launches none."""
    before = (embedding_bag_op.launches, sparse_adagrad_op.launches, easgd_round_op.launches)
    table = torch.zeros((8, 4))
    idx = torch.zeros((2, 2), dtype=torch.int32)
    embedding_bag_op(table, idx)
    sparse_adagrad_op(table, torch.zeros((8, 4)), idx, torch.ones((2, 4)), lr=0.1)
    easgd_round_op(torch.zeros((2, 4, 4)), torch.zeros((4, 4)), torch.ones((1, 4, 4)),
                   torch.tensor([1], dtype=torch.int32), 0.5)
    assert (embedding_bag_op.launches, sparse_adagrad_op.launches,
            easgd_round_op.launches) == before


# ---------------------------------------------------------------------------
# K4 · EASGD pair exchange, and the threaded round built on it
# ---------------------------------------------------------------------------

from repro.core import algorithms as jalgorithms  # noqa: E402
from repro.core import flatspace as jflatspace  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.kernels.easgd_update.easgd_update import easgd_update as j_easgd_update  # noqa: E402
from repro.kernels.easgd_update.ops import easgd_pair_flat_op as j_easgd_pair_flat_op  # noqa: E402
from repro.kernels.easgd_update.ops import easgd_pair_op as j_easgd_pair_op  # noqa: E402
from repro.kernels.easgd_update.ref import easgd_update_ref as j_easgd_update_ref  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import algorithms as talgorithms  # noqa: E402
from repro_torch.core import flatspace as tflatspace  # noqa: E402
from repro_torch.core import sync as tsync  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.easgd_update.ops import easgd_pair_flat_op, easgd_pair_op  # noqa: E402
from repro_torch.kernels.easgd_update.ref import easgd_update_ref  # noqa: E402


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("alpha", [0.5, 0.1, 1.0])
def test_easgd_pair_matches_jax(n, alpha):
    rng = np.random.default_rng(n + int(alpha * 10))
    ps = rng.standard_normal((n, LANE)).astype(np.float32)
    w = rng.standard_normal((n, LANE)).astype(np.float32)
    j_ps, j_w = j_easgd_update(jnp.asarray(ps), jnp.asarray(w), alpha, block=256, interpret=True)
    r_ps, r_w = j_easgd_update_ref(jnp.asarray(ps), jnp.asarray(w), alpha)
    o_ps, o_w = j_easgd_pair_flat_op(jnp.asarray(ps), jnp.asarray(w), alpha)
    tps, tw = _t(ps), _t(w)
    for got in (easgd_update_ref(tps, tw, alpha), easgd_pair_flat_op(tps, tw, alpha)):
        assert got[0] is not tps and got[1] is not tw  # out of place
        for a, b in ((got[0], j_ps), (got[1], j_w), (got[0], r_ps), (got[1], r_w),
                     (got[0], o_ps), (got[1], o_w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(tps.numpy(), ps)  # the inputs are left as they were
    np.testing.assert_array_equal(tw.numpy(), w)


def test_easgd_pair_op_over_trees_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": (rng.standard_normal((7,)).astype(np.float32),)}
    other = T.map(lambda x: (x + 1.5).astype(np.float32), tree)
    want = j_easgd_pair_op(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, other), 0.3)
    got = easgd_pair_op(T.map(_t, tree), T.map(_t, other), 0.3)
    for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _planes(seed, n_rep, n_rows=256):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((n_rows, LANE)).astype(np.float32) for _ in range(n_rep)]
    return ws, rng.standard_normal((n_rows, LANE)).astype(np.float32)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_make_shadow_round_flat_matches_jax(n_rep):
    ws, ps = _planes(n_rep, n_rep)
    jfs = jflatspace.FlatSpace.from_tree({"x": jnp.zeros((256 * LANE,))})
    tfs = tflatspace.FlatSpace.from_tree({"x": torch.zeros((256 * LANE,))})
    j_ws = [jnp.asarray(w) for w in ws]
    j_state, jn = jalgorithms.get("easgd").make_shadow_round(
        jsync.SyncConfig(alpha=0.4), jfs)(j_ws, jnp.asarray(ps))
    t_ws = [_t(w) for w in ws]
    t_state, tn = talgorithms.get("easgd").make_shadow_round(
        tsync.SyncConfig(alpha=0.4), tfs)(t_ws, _t(ps))
    assert tn == jn == n_rep
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), **TOL)
    for a, b in zip(t_ws, j_ws):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_make_shadow_round_pytree_matches_jax(n_rep):
    rng = np.random.default_rng(40 + n_rep)
    trees = [{"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)} for _ in range(n_rep + 1)]
    j_ws = [jax.tree.map(jnp.asarray, t) for t in trees[:-1]]
    j_state, jn = jalgorithms.get("easgd").make_shadow_round(
        jsync.SyncConfig(alpha=0.4, engine="pytree"), None)(j_ws, jax.tree.map(jnp.asarray,
                                                                               trees[-1]))
    t_ws = [T.map(_t, t) for t in trees[:-1]]
    t_state, tn = talgorithms.get("easgd").make_shadow_round(
        tsync.SyncConfig(alpha=0.4, engine="pytree"), None)(t_ws, T.map(_t, trees[-1]))
    assert tn == jn == n_rep
    for a, b in zip(T.leaves([t_state] + t_ws), jax.tree.leaves([j_state] + j_ws)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_base_shadow_round_and_join_hooks_match_jax():
    """The base class's fallback round (stack -> land -> slice) and the
    pytree join bootstrap (live mean), through an oracle-only algorithm."""
    rng = np.random.default_rng(3)
    ws, ps = _planes(3, 3)
    tfs = tflatspace.FlatSpace.from_tree({"x": torch.zeros((256 * LANE,))})
    base = talgorithms.SyncAlgorithm()
    base.land = talgorithms.EASGD().land
    t_ws = [_t(w) for w in ws]
    t_state, n = base.make_shadow_round(tsync.SyncConfig(alpha=0.4), tfs)(t_ws, tfs.unpack(_t(ps)))
    want_stack, want_ps = tsync.easgd_round(torch.stack([_t(w) for w in ws]), _t(ps), 0.4)
    assert n == 1
    np.testing.assert_allclose(torch.stack(t_ws).numpy(), want_stack.numpy(), **TOL)
    stack = rng.standard_normal((4, 5)).astype(np.float32)
    active = np.array([True, False, True, False])
    j_new, _ = jalgorithms.SyncAlgorithm.on_join(None, jnp.asarray(stack), 3, None, active, None)
    t_new, _ = talgorithms.SyncAlgorithm.on_join(None, _t(stack), 3, None, active, None)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), **TOL)
    # the flat join bootstrap is the live mean through K5 replica_mean_rows
    buf = np.stack(ws)
    jfs = jflatspace.FlatSpace.from_tree({"x": jnp.zeros((256 * LANE,))})
    j_buf, _ = jalgorithms.SyncAlgorithm().on_join_flat(jnp.asarray(buf), 2, None, active[:3],
                                                        None, jfs)
    t_in = _t(buf)
    t_buf, _ = base.on_join_flat(t_in, 2, None, active[:3], None, tfs)
    np.testing.assert_allclose(t_buf.numpy(), np.asarray(j_buf), **TOL)
    assert np.array_equal(t_in.numpy(), buf)  # out of place


def test_easgd_join_flat_adopts_the_ps_plane():
    ws, ps = _planes(5, 3)
    buf = torch.stack([_t(w) for w in ws])
    new, state = talgorithms.get("easgd").on_join_flat(buf, 2, _t(ps), [True, True, False],
                                                       None, None)
    assert torch.equal(new[2], _t(ps)) and torch.equal(new[:2], buf[:2]) and state is not None
    assert torch.equal(buf[2], _t(ws[2]))  # out of place


def test_launch_counters_are_exact_under_threads():
    import sys
    import threading

    def op():
        pass

    op.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [backend.count_launch(op) for _ in range(20_000)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert op.launches == 4 * 20_000


def test_host_ids_come_from_index_tensor_without_a_read_back():
    """The K5 pull-back takes its ids from the host: a tensor index_tensor
    made gives back the ids it was made from, the same tensor every call; a
    tensor made elsewhere (even with equal ids) is read back."""
    cpu = torch.device("cpu")
    made = backend.index_tensor([3, 0, 2], cpu)
    assert made is backend.index_tensor((3, 0, 2), cpu)
    made.fill_(7)  # a read back would now see 7s
    assert backend.host_ids(made) == (3, 0, 2)
    made.copy_(torch.tensor([3, 0, 2]))
    other = torch.tensor([3, 0, 2], dtype=torch.int32)
    assert backend.host_ids(other) == (3, 0, 2)
    other[1] = 5
    assert backend.host_ids(other) == (3, 5, 2)


def test_concurrent_first_loads_build_once(monkeypatch):
    import threading
    import time

    calls = []

    def fake_build(names):
        calls.append(list(names))
        time.sleep(0.05)  # a slow nvcc: the other threads arrive meanwhile
        return list(names)

    monkeypatch.setattr(backend, "build", fake_build)
    monkeypatch.setattr(backend, "ctypes", type("C", (), {"CDLL": staticmethod(lambda p: object())}))
    monkeypatch.setattr(backend, "_LIBS", {})
    barrier = threading.Barrier(4)
    libs = []

    def first_call():
        barrier.wait()
        libs.append(backend.load("easgd_update"))

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == [["easgd_update"]] and len(libs) == 4 and len({id(x) for x in libs}) == 1


# ---------------------------------------------------------------------------
# K5 · MA mean and pull-back, K6 · BMUF landing, K7 · gossip
# ---------------------------------------------------------------------------

from repro.core import sync as jsync_  # noqa: E402
from repro.kernels.bmuf_update.ops import bmuf_sync_op as j_bmuf_sync_op  # noqa: E402
from repro.kernels.bmuf_update.ops import bmuf_sync_rows_op as j_bmuf_sync_rows_op  # noqa: E402
from repro.kernels.bmuf_update.ref import bmuf_update_ref as j_bmuf_update_ref  # noqa: E402
from repro.kernels.bmuf_update.ref import bmuf_update_rows_ref as j_bmuf_rows_ref  # noqa: E402
from repro.kernels.gossip_update.ops import gossip_pair_flat_op as j_gossip_pair_op  # noqa: E402
from repro.kernels.gossip_update.ops import gossip_round_op as j_gossip_round_op  # noqa: E402
from repro.kernels.gossip_update.ref import gossip_pair_ref as j_gossip_pair_ref  # noqa: E402
from repro.kernels.gossip_update.ref import gossip_round_ref as j_gossip_round_ref  # noqa: E402
from repro.kernels.ma_update import ops as j_ma_ops  # noqa: E402
from repro.kernels.ma_update import ref as j_ma_ref  # noqa: E402
from repro_torch.kernels.bmuf_update.ops import bmuf_sync_op, bmuf_sync_rows_op  # noqa: E402
from repro_torch.kernels.bmuf_update.ref import (  # noqa: E402
    bmuf_update_ref, bmuf_update_rows_ref)
from repro_torch.kernels.gossip_update.ops import gossip_pair_flat_op, gossip_round_op  # noqa: E402
from repro_torch.kernels.gossip_update.ref import gossip_pair_ref, gossip_round_ref  # noqa: E402
from repro_torch.kernels.ma_update import ops as ma_ops  # noqa: E402
from repro_torch.kernels.ma_update import ref as ma_ref  # noqa: E402

ROWS_CASES = [[0], [0, 2, 3], [3, 1], [0, 1, 2, 3]]


def _stack(seed, n_rep=R, n_rows=NR):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rep, n_rows, LANE)).astype(np.float32), rng


def _i32(ids):
    return np.asarray(ids, np.int32)


def test_replica_mean_matches_jax():
    stack, _ = _stack(11)
    want = np.asarray(j_ma_ops.replica_mean_op(jnp.asarray(stack)))
    want_ref = np.asarray(j_ma_ref.replica_mean_ref(jnp.asarray(stack)))
    for got in (ma_ops.replica_mean_op(_t(stack)), ma_ref.replica_mean_ref(_t(stack))):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("rows", ROWS_CASES)
def test_replica_mean_rows_matches_jax(rows):
    stack, _ = _stack(12 + len(rows))
    r = _i32(rows)
    want = np.asarray(j_ma_ops.replica_mean_rows_op(jnp.asarray(stack), jnp.asarray(r)))
    want_ref = np.asarray(j_ma_ref.replica_mean_rows_ref(jnp.asarray(stack), jnp.asarray(r)))
    for got in (ma_ops.replica_mean_rows_op(_t(stack), _t(r)),
                ma_ref.replica_mean_rows_ref(_t(stack), _t(r))):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("alpha", [0.4, 1.0])
def test_ma_sync_matches_jax(alpha):
    stack, rng = _stack(20)
    mean = rng.standard_normal((NR, LANE)).astype(np.float32)
    want = np.asarray(j_ma_ops.ma_sync_op(jnp.asarray(stack), jnp.asarray(mean), alpha))
    want_ref = np.asarray(j_ma_ref.ma_update_ref(jnp.asarray(stack), jnp.asarray(mean), alpha))
    ts = _t(stack)
    got = ma_ops.ma_sync_op(ts, _t(mean), alpha)
    assert got is ts  # in place
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(ma_ref.ma_update_ref(_t(stack), _t(mean), alpha).numpy(),
                               want_ref, **TOL)
    # out of place: the threaded round's pull-back reads the plane, writes a new one
    src, out = _t(stack[1:2]), torch.empty((1, NR, LANE))
    got = ma_ops.ma_sync_op(src, _t(mean), alpha, out=out)
    assert got is out
    np.testing.assert_array_equal(src.numpy(), stack[1:2])
    np.testing.assert_allclose(out.numpy(), want[1:2], **TOL)


@pytest.mark.parametrize("rows", ROWS_CASES)
def test_ma_sync_rows_matches_jax(rows):
    stack, rng = _stack(30 + len(rows))
    mean = rng.standard_normal((NR, LANE)).astype(np.float32)
    r = _i32(rows)
    want = np.asarray(j_ma_ops.ma_sync_rows_op(jnp.asarray(stack), jnp.asarray(mean),
                                               jnp.asarray(r), 0.3))
    want_ref = np.asarray(j_ma_ref.ma_update_rows_ref(jnp.asarray(stack), jnp.asarray(mean),
                                                      jnp.asarray(r), 0.3))
    for fn in (ma_ops.ma_sync_rows_op, ma_ref.ma_update_rows_ref):
        ts = _t(stack)
        got = fn(ts, _t(mean), _t(r), 0.3)
        assert got is ts
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
        for i in sorted(set(range(R)) - set(rows)):  # dead rows untouched
            assert np.array_equal(got[i].numpy(), stack[i])


@pytest.mark.parametrize("bm,nesterov", [(0.0, False), (0.8, False), (0.9, True)])
@pytest.mark.parametrize("rows", [None, [0, 2, 3]])
def test_bmuf_sync_matches_jax_multi_round(bm, nesterov, rows):
    """State (w_global, velocity) carries across three rounds, as in the
    reference's test (tests/test_flatspace.py:170-191)."""
    stack, rng = _stack(40 + int(bm * 10))
    snap = stack + 0.1 * rng.standard_normal(stack.shape).astype(np.float32)
    wg = stack.mean(0)
    vel = np.zeros_like(wg)
    kw = dict(eta=0.9, block_momentum=bm, nesterov=nesterov)
    j = [jnp.asarray(x) for x in (stack, wg, vel)]
    jr = [jnp.asarray(x) for x in (stack, wg, vel)]
    t = [_t(x) for x in (stack, wg, vel)]
    tr = [_t(x) for x in (stack, wg, vel)]
    j_snap, t_snap = jnp.asarray(snap), _t(snap)
    r = None if rows is None else _i32(rows)
    for _ in range(3):
        if rows is None:
            j = j_bmuf_sync_op(j[0], j_ma_ops.replica_mean_op(j_snap), j[1], j[2], 0.5, **kw)
            jr = j_bmuf_update_ref(jr[0], j_ma_ref.replica_mean_ref(j_snap), jr[1], jr[2], 0.5,
                                   **kw)
            got = bmuf_sync_op(t[0], ma_ops.replica_mean_op(t_snap), t[1], t[2], 0.5, **kw)
            got_r = bmuf_update_ref(tr[0], ma_ref.replica_mean_ref(t_snap), tr[1], tr[2], 0.5,
                                    **kw)
        else:
            jrows = jnp.asarray(r)
            j = j_bmuf_sync_rows_op(j[0], j_ma_ops.replica_mean_rows_op(j_snap, jrows), j[1],
                                    j[2], jrows, 0.5, **kw)
            jr = j_bmuf_rows_ref(jr[0], j_ma_ref.replica_mean_rows_ref(j_snap, jrows),
                                 jr[1], jr[2], jrows, 0.5, **kw)
            got = bmuf_sync_rows_op(t[0], ma_ops.replica_mean_rows_op(t_snap, _t(r)), t[1],
                                    t[2], _t(r), 0.5, **kw)
            got_r = bmuf_update_rows_ref(tr[0], ma_ref.replica_mean_rows_ref(t_snap, _t(r)),
                                         tr[1], tr[2], _t(r), 0.5, **kw)
        assert all(a is b for a, b in zip(got, t)) and all(a is b for a, b in zip(got_r, tr))
        j_snap, t_snap = j[0].copy(), t[0].clone()  # the next launch snapshot
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if rows is not None:
        assert np.array_equal(t[0][1].numpy(), stack[1])  # the dead row is untouched


@pytest.mark.parametrize("alpha", [0.5, 1.0, 0.1])
def test_gossip_pair_matches_jax(alpha):
    _, rng = _stack(50)
    a = rng.standard_normal((NR, LANE)).astype(np.float32)
    b = rng.standard_normal((NR, LANE)).astype(np.float32)
    want = j_gossip_pair_op(jnp.asarray(a), jnp.asarray(b), alpha)
    want_ref = j_gossip_pair_ref(jnp.asarray(a), jnp.asarray(b), alpha)
    ta, tb = _t(a), _t(b)
    for got in (gossip_pair_flat_op(ta, tb, alpha), gossip_pair_ref(ta, tb, alpha)):
        assert got[0] is not ta and got[1] is not tb  # out of place
        for g, w, wr in zip(got, want, want_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(wr), **TOL)
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(tb.numpy(), b)


@pytest.mark.parametrize("land,self_pos,partner_pos", [
    ([0, 1, 2, 3], [0, 1, 2, 3], [1, 0, 3, 2]),  # P = 4: two pairs
    ([1, 3], [0, 1], [1, 0]),                    # P = 2: one pair
    ([2], [0], [1]),                             # a live row whose partner died in flight
])
def test_gossip_round_matches_jax(land, self_pos, partner_pos):
    stack, rng = _stack(60 + len(land))
    snap = rng.standard_normal((max(max(self_pos), max(partner_pos)) + 1, NR, LANE))
    snap = snap.astype(np.float32)
    args = [_i32(x) for x in (land, self_pos, partner_pos)]
    want = np.asarray(j_gossip_round_op(jnp.asarray(stack), jnp.asarray(snap),
                                        *map(jnp.asarray, args), 0.6))
    want_ref = np.asarray(j_gossip_round_ref(jnp.asarray(stack), jnp.asarray(snap),
                                             *map(jnp.asarray, args), 0.6))
    for fn in (gossip_round_op, gossip_round_ref):
        ts = _t(stack)
        got = fn(ts, _t(snap), *map(_t, args), 0.6)
        assert got is ts  # in place
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
        for i in sorted(set(range(R)) - set(land)):
            assert np.array_equal(got[i].numpy(), stack[i])


def test_sync_wrappers_need_a_live_row():
    """As the TPU kernels assert: an empty row set never reaches a kernel
    (the runners guard an all-dead cohort before calling)."""
    stack, mean = torch.zeros((2, 8, LANE)), torch.zeros((8, LANE))
    none = torch.zeros((0,), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one"):
        ma_ops.replica_mean_rows_op(stack, none)
    with pytest.raises(ValueError, match="at least one"):
        ma_ops.ma_sync_rows_op(stack, mean, none, 0.5)
    with pytest.raises(ValueError, match="at least one"):
        bmuf_sync_rows_op(stack, mean, mean.clone(), mean.clone(), none, 0.5)
    with pytest.raises(ValueError, match="at least one"):
        gossip_round_op(stack, stack.clone(), none, none, none, 0.5)


def test_cpu_sync_wrappers_do_not_count_launches():
    ops = (ma_ops.replica_mean_op, ma_ops.replica_mean_rows_op, ma_ops.ma_sync_op,
           ma_ops.ma_sync_rows_op, bmuf_sync_op, bmuf_sync_rows_op, gossip_pair_flat_op,
           gossip_round_op)
    before = [op.launches for op in ops]
    stack, plane = torch.ones((2, 8, LANE)), torch.ones((8, LANE))
    rows = torch.tensor([1], dtype=torch.int32)
    ma_ops.replica_mean_op(stack)
    ma_ops.replica_mean_rows_op(stack, rows)
    ma_ops.ma_sync_op(stack, plane, 0.5)
    ma_ops.ma_sync_rows_op(stack, plane, rows, 0.5)
    bmuf_sync_op(stack, plane, plane.clone(), plane.clone(), 0.5)
    bmuf_sync_rows_op(stack, plane, plane.clone(), plane.clone(), rows, 0.5)
    gossip_pair_flat_op(plane, plane, 0.5)
    gossip_round_op(stack, stack.clone(), rows, torch.tensor([0], dtype=torch.int32),
                    torch.tensor([1], dtype=torch.int32), 0.5)
    assert [op.launches for op in ops] == before


def test_bmuf_plane_kernel_ref_is_the_oracle_round():
    """The flat landing (launch mean + K6) is ``core.sync.bmuf_round`` on
    the launch snapshot, in both packages."""
    stack, rng = _stack(70)
    snap = stack + 0.05
    wg, vel = stack.mean(0) + 0.1, rng.standard_normal((NR, LANE)).astype(np.float32) * 0.01
    kw = dict(eta=0.7, block_momentum=0.5, nesterov=True)
    o_stack, o_state = jsync_.bmuf_round({"w": jnp.asarray(stack)}, jsync_.BMUFState(
        w_global={"w": jnp.asarray(wg)}, velocity={"w": jnp.asarray(vel)}), 0.4,
        snapshot={"w": jnp.asarray(snap)}, **kw)
    t = bmuf_sync_op(_t(stack), ma_ops.replica_mean_op(_t(snap)), _t(wg), _t(vel), 0.4, **kw)
    for a, b in zip(t, (o_stack["w"], o_state.w_global["w"], o_state.velocity["w"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# K9 · flash attention (GQA wrapper), K8 · interaction
# ---------------------------------------------------------------------------

from repro.kernels.flash_attention.ops import gqa_attention_op as j_gqa_attention_op  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.interaction.ops import interaction_op as j_interaction_op  # noqa: E402
from repro.kernels.interaction.ref import interaction_ref as j_interaction_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import gqa_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref, gqa_attention_ref  # noqa: E402
from repro_torch.kernels.interaction.ops import interaction_op  # noqa: E402
from repro_torch.kernels.interaction.ref import interaction_ref  # noqa: E402
from repro_torch.models import dlrm as tdlrm  # noqa: E402

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's (tests/test_kernels.py)


def _qkv(seed, b, s, h, kv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(dtype),
            rng.standard_normal((b, s, kv, d)).astype(dtype),
            rng.standard_normal((b, s, kv, d)).astype(dtype))


def _fold(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("s,h,kv,d", [(128, 4, 4, 64), (256, 4, 2, 64), (256, 8, 1, 128),
                                      (384, 2, 2, 32)])
def test_gqa_attention_matches_jax(s, h, kv, d):
    """The reference tests' shapes at batch 2; the JAX op runs its Pallas
    kernel in interpret mode."""
    q, k, v = _qkv(s + h, 2, s, h, kv, d)
    want = np.asarray(j_gqa_attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = gqa_attention_op(_t(q), _t(k), _t(v))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_gqa_attention_unaligned_causal_matches_jax():
    q, k, v = _qkv(13, 1, 100, 2, 2, 64)
    want = np.asarray(j_gqa_attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=True))
    np.testing.assert_allclose(gqa_attention_op(_t(q), _t(k), _t(v), causal=True).numpy(), want,
                               **ATTN_TOL)


@pytest.mark.parametrize("s", [100, 128])
def test_gqa_attention_noncausal_matches_jax_oracle(s):
    """Non-causal: held against the JAX ``attention_ref``. At S = 100 the
    JAX op itself pads K/V with zeros and lets them into the softmax (a
    reference-side fact); the port masks keys beyond S."""
    q, k, v = _qkv(11 + s, 1, s, 2, 2, 64)
    want = j_attention_ref(jnp.asarray(_fold(q)), jnp.asarray(_fold(k)), jnp.asarray(_fold(v)),
                           causal=False)
    want = np.asarray(want).reshape(1, 2, s, 64).transpose(0, 2, 1, 3)
    got = gqa_attention_op(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax(causal):
    q, k, v = (_fold(x) for x in _qkv(5, 2, 96, 3, 3, 32))
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal))
    np.testing.assert_allclose(attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy(), want,
                               **ATTN_TOL)


def test_gqa_attention_bf16_matches_jax():
    q, k, v = _qkv(17, 1, 128, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_gqa_attention_op(jq, jk, jv, causal=True), np.float32)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = gqa_attention_op(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def _tensor_core_k9(q, k, v, causal, bk=128):
    """The arithmetic of the bf16 tensor-core K9 (csrc/flash_attention.cu),
    emulated on the CPU: q and k in bf16, s = q k^T accumulated in f32 tile
    by tile over ``bk`` keys, the online softmax in f32 in the log2 domain,
    p rounded to bf16 before p v (accumulated in f32), and one bf16 rounding
    of the output. (B, S, H, d) q, (B, S, Hkv, d) k and v, bf16."""
    B, S, H, d = q.shape
    n_rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)  # (B, H, S, d); bf16 products are exact in f32
    kf, vf = (x.float().repeat_interleave(n_rep, 2).transpose(1, 2) for x in (k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((B, H, S, 1), -math.inf)
    l_sum = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, min(k0 + bk, S))[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite: key 0 is in every row
        corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l_sum = l_sum * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (o / l_sum).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("s,d,causal", [(1024, 128, True), (1000, 128, True), (1000, 128, False),
                                        (129, 64, True), (33, 32, False)])
def test_tensor_core_k9_rounding_fits_the_card_tolerance(s, d, causal):
    """Before any card time: the bf16 K9's rounding (bf16 p into p v) holds
    the card tests' bf16 tolerances against the plain version, at phi3's
    head ratio (8 query / 2 KV heads): the prefill shape's atol 6e-3, rtol
    1e-2 and 1e-2 in the relative norm, within the reference's 3e-2."""
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(29 + s, 1, s, 8, 2, d))
    got = _tensor_core_k9(q, k, v, causal).float()
    want = gqa_attention_ref(q, k, v, causal=causal).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=6e-3)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_tensor_core_k9_rounding_matches_jax():
    """The emulation against the JAX op in interpret mode, as
    ``test_gqa_attention_bf16_matches_jax`` holds the port's wrapper."""
    q, k, v = _qkv(17, 1, 128, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_gqa_attention_op(jq, jk, jv, causal=True), np.float32)
    got = _tensor_core_k9(*(_t(x).to(torch.bfloat16) for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def _tf32(x):
    """TF32 rounding of f32 values as the f32 K9 does it (and as
    ``cvt.rna.tf32.f32``): half a TF32 ulp added to the bits, then the 13
    low bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """An f32 operand as the tensor cores read it in TF32: its 13 low bits
    ignored."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32x3_k9(q, k, v, causal, bk, passes=3):
    """The arithmetic of the f32 tensor-core K9 (csrc/flash_attention.cu),
    emulated on the CPU: each operand x of both products split into TF32 hi
    (x rounded) and lo = x - hi (read truncated), and each k-step of 8 (S =
    Q K^T: D's columns in the kernel's order; P V: 8 keys) taken as lo . hi,
    then hi . lo, then hi . hi. S keeps the small products and hi . hi in
    two accumulators, added at the end; each key tile's P V starts from zero
    and is added to O in f32; the online softmax runs tile by tile over
    ``bk`` keys in the log2 domain. ``passes=1`` keeps hi . hi alone (one
    TF32 pass). (B, S, H, d) q, (B, S, Hkv, d) k and v, f32."""
    B, S, H, d = q.shape
    n_rep = H // k.shape[2]
    qf = q.transpose(1, 2)  # (B, H, S, d)
    kf, vf = (x.repeat_interleave(n_rep, 2).transpose(1, 2) for x in (k, v))

    def split(x):
        hi = _tf32(x)
        return hi, _tf32_truncated(x - hi)

    def products(a, b):  # a (.., m, 8) . b (.., 8, n): [small, small, big]
        (ah, al), (bh, bl) = split(a), split(b)
        return [ah @ bh] if passes == 1 else [al @ bh, ah @ bl, ah @ bh]

    # k-step 2c + h takes columns 16c + 4t + 2h, + 1 for t = 0..3
    steps = [[16 * c + 4 * t + 2 * h + e for t in range(4) for e in range(2)]
             for c in range(d // 16) for h in range(2)]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((B, H, S, 1), -math.inf)
    l_sum = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        big = small = torch.zeros((B, H, S, kt.shape[2]))
        for cols in steps:
            *lo, hi = products(qf[..., cols], kt[..., cols].transpose(-1, -2))
            for part in lo:
                small = small + part
            big = big + hi
        s = (big + small) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite: key 0 is in every row
        corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l_sum = l_sum * corr + p.sum(-1, keepdim=True)
        pv = torch.zeros_like(o)
        for j0 in range(0, kt.shape[2], 8):
            for part in products(p[..., j0:j0 + 8], vt[:, :, j0:j0 + 8]):
                pv = pv + part
        o = torch.addcmul(pv, o, corr)
        m = m_new
    return (o / l_sum).transpose(1, 2)


K9_F32_TILE = {128: 32, 64: 64, 32: 64}  # the f32 kernel's key tile by head dim


@pytest.mark.parametrize("s,d,causal", [(1024, 128, True), (1000, 128, True), (1000, 128, False),
                                        (129, 64, True), (33, 32, False)])
def test_tf32x3_k9_holds_f32_accuracy(s, d, causal):
    """Before any card time: the f32 K9's 3xTF32 arithmetic, at phi3's head
    ratio (8 query / 2 KV heads), is within 1e-5 of the plain version (f32
    products) and within the reference's 2e-4 of the JAX op: its Pallas
    kernel in interpret mode where that masks what the port masks (causal,
    or S a multiple of its block of 128), else its plain path (the Pallas
    path lets zero-padded keys into a non-causal softmax)."""
    q, k, v = _qkv(31 + s, 1, s, 8, 2, d)
    got = _tf32x3_k9(_t(q), _t(k), _t(v), causal, K9_F32_TILE[d])
    want = gqa_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    j_out = j_gqa_attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               use_pallas=causal or s % 128 == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), **ATTN_TOL)


def test_one_tf32_pass_misses_the_reference_tolerance():
    """Why the f32 K9 takes three TF32 products: one pass (hi . hi alone)
    lies beyond the reference's 2e-4 at granite-like widths (S = 1,024,
    d = 128, causal), where three passes hold 1e-5."""
    q, k, v = (_t(x) for x in _qkv(31 + 1024, 1, 1024, 8, 2, 128))
    want = gqa_attention_ref(q, k, v, causal=True)
    one = _tf32x3_k9(q, k, v, True, K9_F32_TILE[128], passes=1)
    assert (one - want).abs().max().item() > ATTN_TOL["atol"]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, want, **ATTN_TOL)


@pytest.mark.parametrize("b,f,d", [(64, 9, 16), (128, 27, 64), (100, 5, 32)])
def test_interaction_matches_jax(b, f, d):
    z = np.random.default_rng(b + f).standard_normal((b, f, d)).astype(np.float32)
    want_op = np.asarray(j_interaction_op(jnp.asarray(z)))
    want_ref = np.asarray(j_interaction_ref(jnp.asarray(z)))
    got = interaction_op(_t(z))
    assert got.shape == (b, f * (f - 1) // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_op, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(interaction_ref(_t(z)).numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_interaction_is_the_dlrm_interact_dots():
    """The kernel's function is exactly the dot features of the port's
    ``dlrm.interact`` (as the reference pins for its own)."""
    rng = np.random.default_rng(3)
    bottom = _t(rng.standard_normal((16, 8)).astype(np.float32))
    pooled = _t(rng.standard_normal((16, 4, 8)).astype(np.float32))
    full = tdlrm.interact(bottom, pooled)
    dots = interaction_op(torch.cat([bottom[:, None, :], pooled], dim=1))
    np.testing.assert_allclose(full[:, 8:].numpy(), dots.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_lm_wrappers_do_not_count_launches():
    before = (gqa_attention_op.launches, interaction_op.launches)
    x = torch.ones((1, 4, 2, 32))
    gqa_attention_op(x, x, x)
    interaction_op(torch.ones((2, 3, 4)))
    assert (gqa_attention_op.launches, interaction_op.launches) == before
