"""The port's DLRM, flat packing, optimizers and interop against the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import flatspace as jflat  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import flatspace  # noqa: E402
from repro_torch.core import sync  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402

# fp32 matmuls and reductions summed in another order than XLA's: a few ulp,
# amplified a little through the backward pass.
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_dense(seed=0, cfg=None):
    return jax.tree.map(np.array, jdlrm.init_dense(cfg or jcfg.tiny(), jax.random.PRNGKey(seed)))


def _batch(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((B, cfg.n_dense_features)).astype(np.float32)
    pooled = rng.standard_normal((B, cfg.n_sparse_features, cfg.embedding_dim)).astype(np.float32)
    labels = (rng.uniform(size=B) < 0.3).astype(np.float32)
    return dense, pooled, labels


def _close(port_tree, jax_tree, **tol):
    pl, jl = T.leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("emb_dim", [16, 8])
def test_dense_loss_and_grads_match_jax(emb_dim):
    cfg_j = jcfg.tiny(emb_dim)
    w_np = _jax_dense(cfg=cfg_j)
    dense, pooled, labels = _batch(cfg_j, 24)
    loss, g_w, g_pooled = jdlrm.dense_loss_and_grads(
        jax.tree.map(jnp.asarray, w_np), jnp.asarray(dense), jnp.asarray(pooled),
        jnp.asarray(labels))
    t_loss, t_gw, t_gp = dlrm.dense_loss_and_grads(
        interop.dense_from_numpy(w_np), torch.from_numpy(dense), torch.from_numpy(pooled),
        torch.from_numpy(labels))
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(loss), **TOL)
    _close(t_gw, g_w, **GRAD_TOL)
    np.testing.assert_allclose(t_gp.numpy(), np.asarray(g_pooled), **GRAD_TOL)


def test_batched_weights_give_per_copy_grads():
    """Leading weight dims are independent copies: each copy's gradient is
    that of its own mean loss (what jax.vmap gives the reference)."""
    cfg = jcfg.tiny()
    w = interop.dense_from_numpy(_jax_dense(cfg=cfg))
    dense, pooled, labels = _batch(cfg, 16)
    w2 = T.map(lambda x: x.unsqueeze(0).expand((2,) + tuple(x.shape)), w)
    d2 = torch.from_numpy(np.stack([dense, dense[::-1].copy()]))
    p2 = torch.from_numpy(np.stack([pooled, pooled[::-1].copy()]))
    l2 = torch.from_numpy(np.stack([labels, labels[::-1].copy()]))
    loss, g_w, g_p = dlrm.dense_loss_and_grads(w2, d2, p2, l2)
    for k in range(2):
        lk, gk, gpk = dlrm.dense_loss_and_grads(w, d2[k], p2[k], l2[k])
        torch.testing.assert_close(loss[k], lk, **TOL)
        for a, b in zip(T.leaves(g_w), T.leaves(gk)):
            torch.testing.assert_close(a[k], b, **GRAD_TOL)
        torch.testing.assert_close(g_p[k], gpk, **GRAD_TOL)


@pytest.mark.parametrize("cfg_name", ["tiny", "full"])
def test_flat_packing_same_bytes(cfg_name):
    cfg = jcfg.tiny() if cfg_name == "tiny" else jcfg.CONFIG
    w_np = _jax_dense(cfg=cfg)
    jfs = jflat.FlatSpace.from_tree(w_np)
    tfs = flatspace.FlatSpace.from_tree(interop.dense_from_numpy(w_np))
    assert (tfs.n_rows, tfs.total, tfs.sizes) == (jfs.n_rows, jfs.total, jfs.sizes)
    assert tfs.shapes == jfs.shapes
    plane = tfs.pack(interop.dense_from_numpy(w_np))
    assert np.array_equal(plane.numpy(), np.asarray(jfs.pack(w_np)))
    stack_np = jax.tree.map(lambda x: np.stack([x, 2 * x, -x]), w_np)
    buf = tfs.pack_stack(interop.dense_from_numpy(stack_np))
    assert np.array_equal(buf.numpy(), np.asarray(jfs.pack_stack(stack_np)))
    _close(tfs.unpack_stack(buf), stack_np, rtol=0, atol=0)
    _close(tfs.unpack(plane), w_np, rtol=0, atol=0)
    assert np.array_equal(tfs.broadcast(interop.dense_from_numpy(w_np), 2).numpy(),
                          np.asarray(jfs.broadcast(w_np, 2)))


def test_full_config_flat_space_size():
    """The full DLRM dense space: 499,521 parameters in 4096 rows of 128."""
    fs = flatspace.FlatSpace.from_tree(dlrm.init_dense(dlrm_ctr.CONFIG, torch.Generator()))
    assert (fs.total, fs.n_rows) == (499_521, 4096)


@pytest.mark.parametrize("name", sorted(optim.REGISTRY))
def test_optimizers_match_jax(name):
    """A few steps of each optimizer over a replica-stacked tree (leading R=2)."""
    rng = np.random.default_rng(7)
    w_np = jax.tree.map(lambda x: np.stack([x, x * 0.5]), _jax_dense())
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), w_np)
             for _ in range(3)]
    jopt, topt = joptim.make(name, 0.02), optim.make(name, 0.02)
    jw, tw = jax.tree.map(jnp.asarray, w_np), interop.dense_from_numpy(w_np)
    jst = jax.vmap(jopt.init)(jw)
    tst = topt.init(tw)
    if name == "adam":  # the sim stacks the step counter per replica too
        tst["t"] = torch.zeros((2,), dtype=torch.int32)
    jupd = jax.vmap(jopt.update)
    for g in grads:
        jw, jst = jupd(jw, jst, jax.tree.map(jnp.asarray, g))
        tw, tst = topt.update(tw, tst, interop.dense_from_numpy(g))
    _close(tw, jw, **TOL)


def test_interop_round_trip():
    w_np = _jax_dense()
    w = interop.dense_from_numpy(w_np, device="cpu")
    back = interop.tree_to_numpy(w)
    assert jax.tree.structure(back) == jax.tree.structure(w_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(w_np)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    src = np.ones((4, 3), np.float32)
    tables = interop.tables_from_numpy({"table": src, "acc": src * 0})
    tables["table"] += 1  # a copy: the caller's array is not aliased
    assert np.array_equal(src, np.ones((4, 3), np.float32))
    st = interop.sim_state_from_numpy(
        np.zeros((2, 256, 128), np.float32), {"a": np.zeros((2, 3), np.float32)},
        {"table": src, "acc": src}, np.zeros((256, 128), np.float32), step=5)
    assert st.step == 5 and st.w_stack.shape == (2, 256, 128) and st.algo_state.dtype == torch.float32


def _stack_np(R, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal((R,) + x.shape).astype(np.float32),
                        _jax_dense())


@pytest.mark.parametrize("mask", [None, [True, False, True], [False, False, True]])
@pytest.mark.parametrize("with_snapshot", [False, True])
def test_easgd_round_oracle_matches_jax(mask, with_snapshot):
    stack, ps, snap = _stack_np(3, 1), _jax_dense(seed=2), _stack_np(3, 3)
    j_new, j_ps = jsync.easgd_round(
        jax.tree.map(jnp.asarray, stack), jax.tree.map(jnp.asarray, ps), 0.5,
        mask=None if mask is None else jnp.asarray(mask),
        snapshot=jax.tree.map(jnp.asarray, snap) if with_snapshot else None)
    t_new, t_ps = sync.easgd_round(
        interop.dense_from_numpy(stack), interop.dense_from_numpy(ps), 0.5,
        mask=None if mask is None else np.asarray(mask),
        snapshot=interop.dense_from_numpy(snap) if with_snapshot else None)
    _close(t_new, j_new, **TOL)
    _close(t_ps, j_ps, **TOL)


def test_sync_helpers_match_jax():
    stack, w = _stack_np(3, 4), _jax_dense(seed=5)
    t_stack, t_w = interop.dense_from_numpy(stack), interop.dense_from_numpy(w)
    _close(sync.replica_mean(t_stack), jsync.replica_mean(stack), **TOL)
    _close(sync.tree_slice(t_stack, 1), jsync.tree_slice(stack, 1), rtol=0, atol=0)
    _close(sync.tree_set(t_stack, 2, t_w), jsync.tree_set(jax.tree.map(jnp.asarray, stack), 2, w),
           rtol=0, atol=0)
    _close(sync.lerp(t_w, sync.tree_slice(t_stack, 0), 0.3),
           jsync.lerp(w, jsync.tree_slice(stack, 0), 0.3), **TOL)
    for got, want in zip(sync.easgd_pair_update(t_w, sync.tree_slice(t_stack, 0), 0.3),
                         jsync.easgd_pair_update(w, jsync.tree_slice(stack, 0), 0.3)):
        _close(got, want, **TOL)


def test_sync_config_validates():
    assert sync.SyncConfig().validate().centralized()
    for bad in (dict(engine="x"), dict(mode="x"), dict(gap=0), dict(delay=-1), dict(alpha=2.0)):
        with pytest.raises(ValueError):
            sync.SyncConfig(**bad).validate()
