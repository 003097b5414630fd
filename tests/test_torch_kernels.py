"""The port's kernel wrappers and plain versions against the JAX package's.

On the CPU a wrapper takes its plain PyTorch version; the JAX side runs its
Pallas kernels through ``*_op`` in interpret mode (the default off TPU) and its
``ref`` oracles. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
