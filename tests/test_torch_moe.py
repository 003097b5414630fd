"""The port's MoE layer (``models/moe.py``) against the JAX package's, on the
same weights and tokens.

The JAX weights (``moe_init`` on a reduced config, f32) are carried across
as numpy; the JAX layer runs as the JAX package's own tests run it, on the
CPU. Reduced phi3.5-moe has 4 experts, top-2; reduced kimi-k2 adds its
shared expert. ``reduced()`` makes the layer dropless (capacity factor = the
expert count); capacity factors 1.0 and 0.5 drop assignments. Each case
first asserts that both packages route every token to the same experts and
keep the same assignments, then holds the outputs and the load-balance loss
at the trajectory tolerance, ``rtol=1e-4, atol=1e-5``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
ARCHS = {"phi35moe": "phi3.5-moe-42b-a6.6b", "kimi": "kimi-k2-1t-a32b"}


def _cfgs(name):
    return jreduced(jget_config(ARCHS[name])), reduced(get_config(ARCHS[name]))


@functools.lru_cache(maxsize=None)
def _jax_weights(name):
    jcfg, _ = _cfgs(name)
    return jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)


def _port_weights(name):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, _jax_weights(name)))


def _x(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _jax_routing(name, x, cap):
    """The JAX layer's top-k and dispatch (``repro/models/moe.py:76-79, 88``)."""
    jcfg, _ = _cfgs(name)
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ _jax_weights(name)["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    return (np.asarray(idx),) + tuple(
        np.asarray(a) for a in jmoe._dispatch_indices(idx.reshape(-1), jcfg.moe.n_experts, cap))


@pytest.mark.parametrize("cf", [None, 1.0, 0.5], ids=["dropless", "cf1.0", "cf0.5"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_moe_apply_matches_jax(name, cf):
    jcfg, cfg = _cfgs(name)
    x = _x(cfg)
    cap = moe.capacity(cfg, x.shape[0] * x.shape[1], cf)
    j_idx, j_order, j_dest, j_keep = _jax_routing(name, x, cap)
    params = _port_weights(name)
    _, _, idx = moe.route(params, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg.moe.top_k)
    assert np.array_equal(idx.numpy(), j_idx)
    order, dest, keep = moe._dispatch_indices(idx.reshape(-1), cfg.moe.n_experts, cap)
    assert np.array_equal(order.numpy(), j_order) and np.array_equal(dest.numpy(), j_dest)
    assert np.array_equal(keep.numpy(), j_keep)
    assert keep.all() == (cf is None)  # the capped cases drop assignments
    jy, jaux = jmoe.moe_apply(_jax_weights(name), jnp.asarray(x), jcfg, capacity_factor=cf)
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TRAJ)
    np.testing.assert_allclose(float(aux), float(jaux), **TRAJ)


@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1.0"])
def test_moe_gradients_match_jax(cf):
    """Gradients of a weighted mean of the outputs plus the load-balance
    loss: the router (through the gates and the loss), the experts and the
    shared expert."""
    jcfg, cfg = _cfgs("kimi")
    x = _x(cfg, seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        y, aux = jmoe.moe_apply(p, jnp.asarray(x), jcfg, capacity_factor=cf)
        return jnp.mean(y * r) + aux

    jg = jax.grad(jloss)(_jax_weights("kimi"))
    params = T.map(lambda a: a.requires_grad_(), _port_weights("kimi"))
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg, capacity_factor=cf)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).mean() + aux, T.leaves(params))
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRAJ)


def test_dispatch_indices_match_jax_at_every_capacity():
    rng = np.random.default_rng(3)
    for E, n, cap in ((4, 64, 16), (4, 64, 3), (16, 40, 2), (8, 1, 1)):
        e = rng.integers(0, E, n)
        want = jmoe._dispatch_indices(jnp.asarray(e), E, cap)
        got = moe._dispatch_indices(torch.from_numpy(e), E, cap)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), (E, n, cap)


def test_capacity_is_the_reference_float_arithmetic():
    """``int(max(k, cf * T * k / E))``: at phi3.5-moe's full width a B=4
    decode step has 2 slots an expert, a 4 x 2048 prefill 1,280."""
    full = get_config("phi3.5-moe-42b-a6.6b")
    assert moe.capacity(full, 4) == 2 and moe.capacity(full, 4 * 2048) == 1280
    for name in ARCHS:
        _, cfg = _cfgs(name)
        m = cfg.moe
        for t in (1, 3, 64, 1000):
            for cf in (None, 1.0, 1.25, 0.3):
                f = m.capacity_factor if cf is None else cf
                assert moe.capacity(cfg, t, cf) == int(max(m.top_k, f * t * m.top_k
                                                           / m.n_experts))


def test_dropless_output_is_the_dense_mixture():
    """With room for every assignment, the un-route gives each token the
    gate-weighted sum of its top-k experts (and the shared expert), as a
    plain per-token loop computes it."""
    _, cfg = _cfgs("kimi")
    p = _port_weights("kimi")
    x = torch.from_numpy(_x(cfg, B=1, S=12, seed=4))
    y, _ = moe.moe_apply(p, x, cfg)
    _, gates, idx = moe.route(p, x[0], cfg.moe.top_k)
    for t in range(12):
        want = moe.swiglu(p["shared"], x[0, t])
        for g, e in zip(gates[t], idx[t]):
            h = torch.nn.functional.silu(x[0, t] @ p["w_gate"][e]) * (x[0, t] @ p["w_up"][e])
            want = want + g * (h @ p["w_down"][e])
        torch.testing.assert_close(y[0, t], want, rtol=1e-5, atol=1e-5)


def test_load_balance_loss_positive_and_bounded():
    """As the JAX package's test of the same name."""
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    p = moe.moe_init(torch.Generator().manual_seed(6), cfg, torch.float32)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(7))
    y, aux = moe.moe_apply(p, x, cfg)
    assert y.shape == x.shape
    assert 0.0 < float(aux) < 10.0 * cfg.moe.load_balance_coef * cfg.moe.n_experts


def test_bf16_layer_keeps_an_f32_router():
    cfg = dataclasses.replace(reduced(get_config("kimi-k2-1t-a32b")), dtype="bfloat16")
    p = moe.moe_init(torch.Generator().manual_seed(8), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert all(p[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))
    y, aux = moe.moe_apply(p, torch.randn((2, 8, cfg.d_model)).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
