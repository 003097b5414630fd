"""The port's mamba2 mixer (``models/mamba2.py``) against the JAX package's,
on the same weights and inputs.

The JAX weights (``mamba2_init`` on a reduced config, f32) are carried
across as numpy; the JAX functions run as the JAX package's own tests run
them, on the CPU. Reduced mamba2-780m has one group of 16 heads; reduced
jamba's mixer has 8 groups of 2 heads. The tolerance is the trajectory one,
``rtol=1e-4, atol=1e-5``; the port's chunked scan against its own
sequential decode is held at the reference test's 2e-3
(``tests/test_models.py:151``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import mamba2, transformer  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
ARCHS = {"mamba2": "mamba2-780m", "jamba": "jamba-1.5-large-398b"}


def _cfgs(name):
    return jreduced(jget_config(ARCHS[name])), reduced(get_config(ARCHS[name]))


@functools.lru_cache(maxsize=None)
def _jax_weights(name):
    jcfg, _ = _cfgs(name)
    return jmamba2.mamba2_init(jax.random.PRNGKey(0), jcfg, jnp.float32)


def _port_weights(name):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, _jax_weights(name)))


def _x(cfg, B, L, seed=0):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model)).astype(np.float32)


def test_effective_chunk_is_the_reference_rule():
    for chunk in (32, 256):
        for L in range(1, 600):
            assert mamba2.effective_chunk(L, chunk) == jmamba2.effective_chunk(L, chunk), L
    assert mamba2.effective_chunk(37, 32) == 1  # a prime length: 37 steps of one position


@pytest.mark.parametrize("L", [64, 48, 37], ids=["chunks_of_32", "chunks_of_24", "prime"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_mamba2_apply_matches_jax(name, L):
    jcfg, cfg = _cfgs(name)
    x = _x(cfg, 2, L)
    want = np.asarray(jmamba2.mamba2_apply(_jax_weights(name), jnp.asarray(x), jcfg))
    got = mamba2.mamba2_apply(_port_weights(name), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_state_matches_the_reference_final_state(name):
    """The state handed to decode comes from the one scan of
    ``mamba2_apply``; the reference reruns the scan for it
    (``repro/models/transformer.py:176-205``)."""
    jcfg, cfg = _cfgs(name)
    x = _x(cfg, 2, 80, seed=1)  # chunks of 20
    want = jtransformer._mamba_final_state(_jax_weights(name), jnp.asarray(x), jcfg)
    _, ssm, conv = mamba2.mamba2_apply(_port_weights(name), torch.from_numpy(x), cfg,
                                       return_state=True)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(want["ssm"]), **TRAJ)
    np.testing.assert_allclose(conv.numpy(), np.asarray(want["conv"]), **TRAJ)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_mamba2_decode_matches_jax(name):
    """Four steps from a random state: outputs and the carried state."""
    jcfg, cfg = _cfgs(name)
    rng = np.random.default_rng(2)
    j_cache = jmamba2.init_mamba_cache(jcfg, 2, jnp.float32)
    j_cache = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in j_cache.items()}
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in j_cache.items()}
    j_cache = {k: jnp.asarray(v) for k, v in j_cache.items()}
    x = _x(cfg, 2, 4, seed=3)
    params = _port_weights(name)
    for t in range(4):
        jy, j_cache = jmamba2.mamba2_decode(_jax_weights(name), jnp.asarray(x[:, t:t + 1]),
                                            jcfg, j_cache)
        ty, t_cache = mamba2.mamba2_decode(params, torch.from_numpy(x[:, t:t + 1]), cfg,
                                           t_cache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TRAJ)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(j_cache[key]), **TRAJ)


def test_mamba2_gradients_match_jax():
    """The gradients of a weighted mean of the outputs (a loss's scale),
    every weight and the input, at L=64 (two chunks) on reduced jamba's
    grouped mixer."""
    jcfg, cfg = _cfgs("jamba")
    x = _x(cfg, 2, 64, seed=4)
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.mean(jmamba2.mamba2_apply(p, xx, jcfg) * r)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_jax_weights("jamba"), jnp.asarray(x))
    params = T.map(lambda a: a.requires_grad_(), _port_weights("jamba"))
    xt = torch.from_numpy(x).requires_grad_()
    loss = (mamba2.mamba2_apply(params, xt, cfg) * torch.from_numpy(r)).mean()
    grads = torch.autograd.grad(loss, T.leaves(params) + [xt])
    for g, w in zip(grads[:-1], jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRAJ)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TRAJ)


def test_ssd_chunked_matches_sequential_recurrence():
    """The port's chunked SSD against its own decode steps (the state-space
    duality), as ``test_mamba2_ssd_matches_sequential_recurrence``."""
    cfg = reduced(get_config("mamba2-780m"))
    p = mamba2.mamba2_init(torch.Generator().manual_seed(5), cfg, torch.float32)
    x = torch.from_numpy(_x(cfg, 1, 64, seed=6)) * 0.5
    y_chunked = mamba2.mamba2_apply(p, x, cfg)
    cache = mamba2.init_mamba_cache(cfg, 1, torch.float32)
    ys = []
    for t in range(64):
        yt, cache = mamba2.mamba2_decode(p, x[:, t:t + 1], cfg, cache)
        ys.append(yt)
    torch.testing.assert_close(y_chunked, torch.cat(ys, dim=1), rtol=2e-3, atol=2e-3)


def _literal_decay(a_cum):
    """The reference's form: exponentiate the whole square, then mask."""
    q = a_cum.shape[-1]
    idx = torch.arange(q)
    full = torch.exp(a_cum[..., :, None] - a_cum[..., None, :])
    return torch.where(idx[:, None] >= idx[None, :], full, 0.0)


def test_masked_exponent_is_bitwise_the_literal_form():
    """At decays that overflow the literal form above the diagonal (dt·A
    down to -4.8 a position, 256 positions) the two agree bitwise: the
    literal form's ``inf`` sits only where its mask picks 0."""
    rng = np.random.default_rng(7)
    a = -torch.from_numpy(rng.uniform(0.0, 4.8, (2, 48, 256)).astype(np.float32))
    a_cum = torch.cumsum(a, dim=-1)
    literal = torch.exp(a_cum[..., :, None] - a_cum[..., None, :])
    assert torch.isinf(literal).any()  # the case that matters
    got = mamba2.decay_matrix(a_cum)
    assert torch.equal(got, _literal_decay(a_cum))
    assert torch.isfinite(got).all()


def _full_width_grads():
    cfg = get_config("mamba2-780m")
    p = mamba2.mamba2_init(torch.Generator().manual_seed(8), cfg, torch.float32)
    p = T.map(lambda a: a.requires_grad_(), p)
    x = torch.from_numpy(_x(cfg, 1, 256, seed=9))
    loss = mamba2.mamba2_apply(p, x, cfg).square().mean()
    return dict(zip(sorted(p), torch.autograd.grad(loss, T.leaves(p))))


def test_full_width_layer_gradients_are_finite(monkeypatch):
    """One mamba2-780m layer at full width (48 heads, chunk 256), f32, B=1,
    L=256: every gradient finite. With the reference's literal form of the
    decay the same gradients are NaN (the overflow above the diagonal)."""
    grads = _full_width_grads()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values()), \
        [k for k, g in grads.items() if not torch.isfinite(g).all()]
    monkeypatch.setattr(mamba2, "decay_matrix", _literal_decay)
    literal = _full_width_grads()
    assert torch.isnan(literal["A_log"]).any() and torch.isnan(literal["in_proj"]).any()


def test_prefill_refuses_a_prompt_shorter_than_the_conv_state():
    cfg = reduced(get_config("mamba2-780m"))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="d_conv - 1"):
        transformer.prefill(params, cfg, torch.zeros((1, cfg.ssm.d_conv - 2), dtype=torch.long),
                            8)
    logits, _ = transformer.prefill(params, cfg,
                                    torch.zeros((1, cfg.ssm.d_conv - 1), dtype=torch.long), 8)
    assert torch.isfinite(logits).all()
