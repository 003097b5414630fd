"""The port's audio family (``models/whisper.py``, the audio branches of
``core/spmd.py``, layernorm, the GELU MLP, non-causal and cross attention)
against the JAX package's, on the same weights and inputs.

Weights are drawn by the JAX package (``spmd.init_params``) and carried
across as numpy (``interop.lm_params_from_numpy``); inputs are made with
numpy. The config is whisper-base reduced (2 + 2 layers, d_model 256, 4
heads of 64, 64 frames, f32), its vocab cut to 500 where a case needs the
padded head (512 columns). Layers are held at ``rtol=1e-5, atol=1e-6``,
whole passes, gradients and training steps at the trajectory tolerance
``rtol=1e-4, atol=1e-5`` (``tests/test_flatspace.py:233``), and serving as
``tests/test_torch_serve.py`` holds it (2e-4), unless a case's docstring
says otherwise.
"""
import contextlib
import dataclasses
import functools
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import spmd as jspmd  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.core import algorithms as jalgorithms  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import algorithms, spmd  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers, whisper  # noqa: E402

LAYER = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "whisper-base"
B, S_TEXT = 2, 12


def _cfgs(**kw):
    return (dataclasses.replace(jreduced(jget_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


@functools.lru_cache(maxsize=None)
def _jax_weights(vocab=None, dtype=None):
    kw = {k: v for k, v in (("vocab_size", vocab), ("dtype", dtype)) if v is not None}
    return jspmd.init_params(_cfgs(**kw)[0], jax.random.PRNGKey(0))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol=TRAJ):
    got, want = T.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def _frames(cfg, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder.n_ctx, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(vocab, b=B, s=S_TEXT, seed=0):
    return np.random.default_rng(seed + 1).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_layernorm_and_gelu_mlp_match_jax():
    """layernorm (f32, population variance, scale and bias) and the GELU MLP
    (no biases, tanh approximation) on random weights."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jlayers.layernorm(p, jnp.asarray(x), 1e-5)
    got = layers.layernorm(interop.dense_from_numpy(p), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    m = {"w_up": (rng.standard_normal((64, 160)) / 8).astype(np.float32),
         "w_down": (rng.standard_normal((160, 64)) / 13).astype(np.float32)}
    want = jlayers.gelu_mlp(m, jnp.asarray(x))
    got = layers.gelu_mlp(interop.dense_from_numpy(m), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("length,channels", [(64, 256), (448, 512), (1500, 512)])
def test_sinusoids_match_jax(length, channels):
    """``sinusoids`` and ``sinusoids_at``. The timescales ``exp(-c * i)`` are
    held to one f32 ulp: XLA's f32 exp and torch's differ by one ulp at
    some of them (21 of 256 at 512 channels), neither correctly rounded.
    The angle ``pos * inv`` then differs by up to pos * 2**-24, and its f32
    rounding by one more ulp of pos, so sin and cos are held within
    ``pos_max * 2**-24 + ulp(pos_max)`` on top of 1e-6: a bound derived from
    those roundings (1.5e-4 at 1,500 positions), not fitted."""
    half = channels // 2
    lt = jnp.log(10000.0) / (half - 1)
    j_inv = np.asarray(jnp.exp(-lt * jnp.arange(half, dtype=jnp.float32)))
    pos_max = length - 1
    t_inv = torch.exp(-(math.log(10000.0) / (half - 1)) * torch.arange(half, dtype=torch.float32))
    np.testing.assert_allclose(t_inv.numpy(), j_inv, rtol=2.0 ** -23, atol=0)
    atol = pos_max * 2.0 ** -24 + float(np.spacing(np.float32(pos_max))) + 1e-6
    want = np.asarray(jwhisper.sinusoids(length, channels))
    got = whisper.sinusoids(length, channels)
    assert tuple(got.shape) == want.shape == (length, channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAYER["rtol"], atol=atol)
    pos = np.array([0, 3, pos_max], np.int32)
    want = np.asarray(jwhisper.sinusoids_at(jnp.asarray(pos), channels))
    got = whisper.sinusoids_at(torch.from_numpy(pos), channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAYER["rtol"], atol=atol)
    # at the first positions the bound is the stated 1e-6 itself
    want = np.asarray(jwhisper.sinusoids_at(jnp.arange(2), channels))
    got = whisper.sinusoids_at(torch.arange(2), channels)
    np.testing.assert_allclose(got.numpy(), want, **LAYER)


def _attn_weights(cfg, seed=5):
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim
    shapes = {"wq": (cfg.d_model, cfg.n_heads * hd), "wk": (cfg.d_model, cfg.n_kv_heads * hd),
              "wv": (cfg.d_model, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, cfg.d_model)}
    return {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("train", [False, True], ids=["prefill_form", "train_form"])
@pytest.mark.parametrize("kind,S", [("noncausal", 64), ("noncausal", 1500), ("cross", 12),
                                    ("cross", 1100)])
def test_attention_apply_noncausal_and_cross_match_jax(kind, S, train):
    """Non-causal self-attention (whisper's encoder; the prefill form is
    K9's plain version, the training form the query-chunked path: 1,500 in
    chunks of 750) and cross-attention (always the chunked path; 1,100
    queries in chunks of 550) against ``attention_apply``. GQA (4 query
    heads on 2 KV heads) and a 1,500-row encoder output."""
    jcfg, cfg = _cfgs(n_kv_heads=2)
    rng = np.random.default_rng(S)
    x = (rng.standard_normal((1, S, cfg.d_model)) * 0.5).astype(np.float32)
    enc = (rng.standard_normal((1, 1500, cfg.d_model)) * 0.5).astype(np.float32)
    p = _attn_weights(cfg)
    jkw = dict(causal=False) if kind == "noncausal" else dict(cross_kv=(jnp.asarray(enc), None))
    want = jlayers.attention_apply(p, jnp.asarray(x), jcfg, positions=jnp.arange(S), **jkw)
    tkw = dict(causal=False) if kind == "noncausal" else dict(
        cross_kv=(torch.from_numpy(enc), None))
    tp = interop.dense_from_numpy(p)
    xt = torch.from_numpy(x).requires_grad_(train)
    got = layers.attention_apply(tp, xt, cfg, positions=torch.arange(S), train=train, **tkw)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_attention_decode_cross_matches_jax():
    """One query against a precomputed encoder K/V (GQA): every key, no RoPE,
    and the cache handed back untouched."""
    jcfg, cfg = _cfgs(n_kv_heads=2)
    rng = np.random.default_rng(7)
    hd = cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, 64, cfg.n_kv_heads, hd)).astype(np.float32)
            for _ in range(2))
    p = _attn_weights(cfg)
    jc = jlayers.init_attention_cache(jcfg, B, 8, jnp.float32)
    want, _ = jlayers.attention_decode(p, jnp.asarray(x), jcfg, jc, jnp.asarray(3, jnp.int32),
                                       cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    tc = layers.init_attention_cache(cfg, B, 8, torch.float32)
    got, back = layers.attention_decode(interop.dense_from_numpy(p), torch.from_numpy(x), cfg,
                                        tc, 3, cross_kv=(torch.from_numpy(k),
                                                         torch.from_numpy(v)))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    assert back is tc and not any(t.any() for t in tc.values())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_init_params_layout_matches_jax():
    """Same tree, same shapes and dtypes as the JAX package's init, drawn by
    ``spmd.init_params``; the encoder's and decoder's stacks."""
    jcfg, cfg = _cfgs()
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, _jax_weights()))
    got = interop.tree_to_numpy(spmd.init_params(cfg, torch.Generator().manual_seed(0),
                                                 device="cpu"))
    for path, w in want:
        g = got
        for key in path:
            g = g[key.key]
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
    assert len(T.leaves(got)) == len(want)
    assert got["enc"]["attn"]["wq"].shape[0] == cfg.encoder.n_layers
    assert got["dec"]["cross_attn"]["wk"].shape[0] == cfg.n_layers


def test_encode_and_decode_full_match_jax():
    """``encode``, ``decode_full``'s logits (padded columns masked) and
    ``return_kv``'s K/V, which are the reference's literal ones: each
    layer's self-attention ``wk``/``wv`` applied to the MLP's normed input."""
    jcfg, cfg = _cfgs(vocab_size=500)
    jp = _jax_weights(vocab=500)
    tp = _port(jp)
    frames, toks = _frames(cfg), _tokens(cfg.vocab_size)
    je = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    te = whisper.encode(tp, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(te), _np(je), **TRAJ)
    jl, jkv = jwhisper.decode_full(jp, jcfg, jnp.asarray(toks), je, return_kv=True)
    tl, tkv = whisper.decode_full(tp, cfg, torch.from_numpy(toks).long(),
                                  torch.from_numpy(np.array(je)), return_kv=True)
    assert tuple(tl.shape) == jl.shape == (B, S_TEXT, 512)
    np.testing.assert_allclose(_np(tl), _np(jl), **TRAJ)
    assert (tl[..., cfg.vocab_size:] == -1e30).all()
    _close(tkv, jkv)
    assert tuple(tkv["k"].shape) == (cfg.n_layers, B, S_TEXT, cfg.n_kv_heads, 64)
    # not the self-attention's keys: those come from the norm1 input
    h = T.map(lambda a: a[0], tp["dec"])
    x0 = layers.embed_lookup(tp["embed"], torch.from_numpy(toks).long()) + whisper.sinusoids(
        S_TEXT, cfg.d_model)
    k_self = layers.layernorm(h["norm1"], x0, cfg.norm_eps) @ h["self_attn"]["wk"]
    assert not torch.allclose(k_self.reshape(tkv["k"][0].shape), tkv["k"][0])


def test_loss_and_grads_match_jax():
    """``loss_fn`` (the training form: 64 frames in one query chunk, the CE
    over the padded tied head) and every gradient."""
    jcfg, cfg = _cfgs(vocab_size=500)
    jp = _jax_weights(vocab=500)
    frames, toks = _frames(cfg), _tokens(cfg.vocab_size)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jl, jg = jax.value_and_grad(lambda p: jwhisper.loss_fn(p, jcfg, jbatch))(jp)
    live = T.map(lambda a: a.requires_grad_(), _port(jp))
    tl = whisper.loss_fn(live, cfg, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(tl, T.leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TRAJ)
    _close(T.unflatten(live, list(grads)), jg)


def test_decode_matches_full():
    """The reference's ``test_whisper_decode_matches_full``
    (``tests/test_models.py:94``) on the port: greedy-free teacher forcing
    of 16 tokens through ``decode_step`` against ``decode_full`` (atol
    5e-4, the reference's bound), and each step held to the JAX package's."""
    jcfg, cfg = _cfgs()
    jp = _jax_weights()
    tp = _port(jp)
    frames, toks = _frames(cfg, seed=2), _tokens(cfg.vocab_size, s=16, seed=2)
    enc = whisper.encode(tp, cfg, torch.from_numpy(frames))
    full = whisper.decode_full(tp, cfg, torch.from_numpy(toks).long(), enc)
    cache = whisper.init_cache(cfg, B, 16)
    cache = {"self": cache["self"], "cross": whisper.build_cross_cache(tp, cfg, enc)}
    je = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    jc = jwhisper.init_cache(jcfg, B, 16)
    jc = {"self": jc["self"], "cross": jwhisper.build_cross_cache(jp, jcfg, je)}
    _close(cache["cross"], jc["cross"])
    jstep = jax.jit(lambda c, tok, pos: jwhisper.decode_step(jp, jcfg, c, tok, pos))
    for t in range(16):
        lg, cache = whisper.decode_step(tp, cfg, cache, torch.from_numpy(toks[:, t]).long(), t)
        jl, jc = jstep(jc, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(_np(lg), _np(full[:, t, : cfg.vocab_size]), atol=5e-4)
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    _close(cache["self"], jc["self"], TOL)


@functools.lru_cache(maxsize=None)
def _jax_serve(n_gen=8):
    """The JAX package's audio prefill and greedy decode, jitted, on reduced
    whisper with the vocab cut to 500 (the head padded to 512)."""
    jcfg, cfg = _cfgs(vocab_size=500)
    jp = _jax_weights(vocab=500)
    frames, toks = _frames(cfg), _tokens(cfg.vocab_size)
    s_max = S_TEXT + n_gen
    logits, cache = jax.jit(jspmd.make_prefill_step(jcfg, s_max))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    out = {"prefill_logits": np.asarray(logits), "prefill_cache": jax.tree.map(np.asarray, cache)}
    decode = jax.jit(jspmd.make_decode_step(jcfg))
    tok, steps = jnp.argmax(logits, -1), []
    for i in range(n_gen):
        logits, cache = decode(jp, cache, tok, jnp.asarray(S_TEXT + i, jnp.int32))
        tok = jnp.argmax(logits, -1)
        steps.append((np.asarray(tok), np.asarray(logits)))
    out["steps"], out["final_cache"] = steps, jax.tree.map(np.asarray, cache)
    return out


def test_spmd_audio_prefill_and_greedy_decode_match_jax():
    """``spmd``'s audio prefill, literally the reference's: the self cache
    is ``init_cache``'s zeros (the prompt's K/V are never cached), the
    logits ``hidden[:, -1] @ table.T`` over all 512 padded columns, the
    padding unmasked; then 8 greedy steps against the JAX package's."""
    jcfg, cfg = _cfgs(vocab_size=500)
    want = _jax_serve()
    tp = _port(_jax_weights(vocab=500))
    frames, toks = _frames(cfg), _tokens(cfg.vocab_size)
    logits, cache = spmd.make_prefill_step(cfg, S_TEXT + 8)(
        tp, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks).long()})
    assert tuple(logits.shape) == (B, 512)
    np.testing.assert_allclose(_np(logits), want["prefill_logits"], **TOL)
    assert (logits[:, cfg.vocab_size:] > -1e29).all()  # the padded columns, unmasked
    assert not any(t.any() for t in cache["self"].values())  # zeros: nothing cached
    _close(cache, want["prefill_cache"], TOL)
    decode = spmd.make_decode_step(cfg)
    tok = torch.argmax(logits, -1)
    for i, (j_tok, j_logits) in enumerate(want["steps"]):
        logits, cache = decode(tp, cache, tok, S_TEXT + i)
        tok = torch.argmax(logits, -1)
        assert tuple(logits.shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), j_logits, **TOL)
        assert np.array_equal(tok.numpy(), j_tok), (i, tok, j_tok)
    _close(cache, want["final_cache"], TOL)


def test_spmd_entry_points_work_for_audio():
    """The five entry points that refused the audio family before it was
    ported: ``init_params`` draws whisper's tree, ``init_cache`` its self and
    cross caches, ``make_train_step`` takes a step on {tokens, frames}, and
    the prefill and decode steps serve."""
    _, cfg = _cfgs()
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(params) == ["dec", "dec_norm", "embed", "enc", "enc_norm"]
    cache = spmd.init_cache(cfg, 2, 8)
    assert tuple(cache["self"]["k"].shape) == (cfg.n_layers, 2, 8, cfg.n_kv_heads, 64)
    assert tuple(cache["cross"]["v"].shape) == (cfg.n_layers, 2, 64, cfg.n_kv_heads, 64)
    stack = spmd.stack_replicas(params, 2)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size)).long().reshape(2, 1, S_TEXT),
             "frames": torch.from_numpy(_frames(cfg)).reshape(2, 1, 64, cfg.d_model)}
    before = stack["dec"]["mlp"]["w_up"].clone()
    stack, _, loss = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")(stack, (), batch)
    assert loss.shape == (2,) and torch.isfinite(loss).all()
    assert not torch.equal(before, stack["dec"]["mlp"]["w_up"])
    one = {"tokens": batch["tokens"][0], "frames": batch["frames"][0]}
    logits, c = spmd.make_prefill_step(cfg, S_TEXT + 2)(params, one)
    logits, _ = spmd.make_decode_step(cfg)(params, c, torch.argmax(logits, -1), S_TEXT)
    assert tuple(logits.shape) == (1, cfg.vocab_size) and torch.isfinite(logits).all()


@pytest.mark.parametrize("algo", ["easgd", "ma"])
def test_shadow_step_and_sync_match_jax(algo):
    """One shadow train step (R=2, SGD) on {tokens, frames} and one sync of
    ``algo``, against the JAX package's jitted steps."""
    jcfg, cfg = _cfgs()
    R = 2
    jp = _jax_weights()
    jstack = jax.tree.map(jnp.copy, jspmd.stack_replicas(jp, R))
    rng = np.random.default_rng(11)
    frames = (rng.standard_normal((R, 2, jcfg.encoder.n_ctx, jcfg.d_model)) * 0.1).astype(
        np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (R, 2, S_TEXT)).astype(np.int32)
    jsc = jsync.SyncConfig(algo=algo, alpha=0.5).validate()
    jalgo = jalgorithms.get(algo).init_state(jp, jsc)
    jstep = jax.jit(jspmd.make_train_step(jcfg, joptim.sgd(0.1), "shadow"))
    jbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    jstack, _, jloss = jstep(jstack, (), jbatch)
    jstack, jalgo = jax.jit(jspmd.make_sync_step(jcfg, jsc))(jstack, jalgo)

    tp = _port(jp)
    stack = spmd.stack_replicas(tp, R)
    sc = SyncConfig(algo=algo, alpha=0.5).validate()
    talgo = algorithms.get(algo).init_state(tp, sc)
    stack, _, loss = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")(
        stack, (), {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(frames)})
    stack, talgo = spmd.make_sync_step(cfg, sc)(stack, talgo)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TRAJ)
    _close(stack, jstack)
    if algo == "easgd":
        _close(talgo, jalgo)


def test_f32_frames_on_bf16_weights_follow_jax_promotion():
    """The reference's launcher draws f32 frames; on bf16 weights JAX
    promotes f32 @ bf16 to f32, so the encoder runs in f32 and the
    cross-attention's K/V are f32. The port follows (``layers.mm``,
    ``layers.promoted``): ``encode`` and ``build_cross_cache`` in f32 within
    the trajectory tolerance (f32 arithmetic on the same bf16 weights), and
    a bf16 query against f32 encoder K/V in ``attention_apply`` and
    ``attention_decode``: f32 out, the probabilities rounded to bf16 as
    JAX rounds them, within 1e-2 relative norm (the bf16 query's own
    products round at other places). JAX's ``decode_full`` and
    ``decode_step`` stop there: the residual turns f32 at the first
    cross-attention and ``lax.scan`` refuses a carry that changes dtype.
    The port's layer loop carries the promoted f32 residual on."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = _jax_weights(dtype="bfloat16")
    tp = _port(jp)
    assert tp["enc"]["attn"]["wq"].dtype == torch.bfloat16
    frames = _frames(cfg)
    je = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    te = whisper.encode(tp, cfg, torch.from_numpy(frames))
    assert te.dtype == torch.float32 and je.dtype == jnp.float32
    np.testing.assert_allclose(_np(te), _np(je), **TRAJ)
    jc = jwhisper.build_cross_cache(jp, jcfg, je)
    tc = whisper.build_cross_cache(tp, cfg, te)
    assert tc["k"].dtype == torch.float32 and jc["k"].dtype == jnp.float32
    _close(tc, jc)

    def rel(got, want):
        got, want = _np(got), _np(want)
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((B, S_TEXT, cfg.d_model)), jnp.bfloat16)
    xt = interop.dense_from_numpy(np.asarray(x))
    lp = jax.tree.map(lambda a: a[0], jp["dec"])["cross_attn"]
    tlp = T.map(lambda a: a[0], tp["dec"])["cross_attn"]
    want = jlayers.attention_apply(lp, x, jcfg, positions=jnp.arange(S_TEXT), cross_kv=(je, None))
    got = layers.attention_apply(tlp, xt, cfg, positions=torch.arange(S_TEXT), cross_kv=(te, None))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(got, want) <= 1e-2
    kv = (jc["k"][0], jc["v"][0])
    want, _ = jlayers.attention_decode(lp, x[:, :1], jcfg, None, jnp.asarray(0), cross_kv=kv)
    got, _ = layers.attention_decode(tlp, xt[:, :1], cfg, None, 0,
                                     cross_kv=(tc["k"][0], tc["v"][0]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(got, want) <= 1e-2


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

def test_lm_launcher_refuses_audio():
    """The lm launcher's token stream carries no frames: a clear exit, not
    frames made up (the reference's ``run_lm`` fails inside its loss)."""
    with pytest.raises(SystemExit, match="carries no audio frames"):
        train.main(["lm", "--device", "cpu", "--arch", ARCH, "--iters", "2"])


def test_serve_frontend_inputs_are_drawn_as_the_reference_draws_them():
    """``make_frontend``: frames (B, n_ctx, d) x 0.1 for audio, prefix
    embeddings (B, n_tokens, d) for vlm, nothing otherwise; from their own
    stream, in the dtype asked for."""
    _, cfg = _cfgs()
    f = serve.make_frontend(cfg, 3, 0)
    assert list(f) == ["frames"] and tuple(f["frames"].shape) == (3, 64, cfg.d_model)
    assert 0.08 < float(f["frames"].std()) < 0.12
    bf = serve.make_frontend(cfg, 3, 0, torch.bfloat16)["frames"]
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, f["frames"].to(torch.bfloat16))
    vlm = reduced(get_config("llava-next-34b"))
    assert tuple(serve.make_frontend(vlm, 2, 0)["prefix_embeds"].shape) == (2, 16, vlm.d_model)
    assert serve.make_frontend(reduced(get_config("phi3-medium-14b")), 2, 0) == {}


def test_example_trains_whisper_on_frames(capsys):
    """``examples/torch_lm_shadowsync.py`` feeds stubbed frames to whisper."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch_lm_shadowsync.py")
    spec = importlib.util.spec_from_file_location("torch_lm_shadowsync_w", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        losses = mod.main(["--device", "cpu", "--arch", ARCH, "--iters", "6"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert f"{ARCH}:" in out.getvalue()
