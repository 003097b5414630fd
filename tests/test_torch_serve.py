"""The port's LM serving path (prefill + greedy decode) against the JAX
package's, on the same weights and prompts.

The JAX weights (``spmd.init_params`` on a reduced config, f32) are carried
across as numpy with ``interop.lm_params_from_numpy``; the JAX steps run
jitted on the CPU, as its launcher runs them. Reduced phi3-medium-14b keeps
GQA (4 query heads on 2 KV heads); reduced minicpm-2b is MHA with tied
embeddings, and its vocab is cut to 500 so the head is padded to 512;
phi3 with a 64-token sliding window runs the query-chunked plain attention
path (K9 has no window); reduced granite-20b is MQA (4 query heads on 1 KV
head). The other families, reduced: mamba2-780m (ssm: two mamba2 layers, a
16-head SSD state and a conv state in the cache), jamba-1.5-large (hybrid:
a mamba2 layer with a SwiGLU, then an attention layer with MoE),
phi3.5-moe (MoE, 4 experts top-2) and kimi-k2 (MoE with a shared expert);
``reduced()`` makes MoE dropless. A bf16 reduced phi3 is held to the JAX
package at a bound set for bf16 rounding.
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
from repro.core import spmd as jspmd  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TRAJ = dict(rtol=1e-4, atol=1e-5)
N_DECODE = 8
# (arch, the reduced config's overrides)
ARCHS = {"phi3": ("phi3-medium-14b", dict(n_kv_heads=2)),
         "minicpm": ("minicpm-2b", dict(vocab_size=500)),
         # the CPU's plain path for a window (CONFIG_SWA's, cut as reduced() cuts it)
         "phi3_swa": ("phi3-medium-14b", dict(n_kv_heads=2, sliding_window=64)),
         # MQA, as granite-20b and -34b: every query head on one KV head
         "granite": ("granite-20b", {}),
         "mamba2": ("mamba2-780m", {}),
         "jamba": ("jamba-1.5-large-398b", {}),
         "phi35moe": ("phi3.5-moe-42b-a6.6b", {}),
         "kimi": ("kimi-k2-1t-a32b", {})}
FAMILIES = ("mamba2", "jamba", "phi35moe", "kimi")
# bf16 serving: the two packages round to bf16 at other places (the port's
# prefill attention keeps f32 scores, the JAX package's bf16 scores and
# probabilities), so the prefill logits differ by ~1% in norm. Measured on
# reduced phi3 (2 layers, d_model 256, 4/2 heads): relative norm 1.38% at
# S=64 and 1.18% at S=200, max abs 0.047; decode logits 0.9-1.3% a step.
BF16_REL_NORM = 2e-2


def _cfgs(name):
    arch, kw = ARCHS[name]
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


@functools.lru_cache(maxsize=None)
def _jax_weights(name):
    jcfg, _ = _cfgs(name)
    return jspmd.init_params(jcfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_run(name, prompt_len):
    """The JAX prefill, then N_DECODE greedy steps: tokens, logits, caches."""
    jcfg, _ = _cfgs(name)
    params = _jax_weights(name)
    toks = _prompts(jcfg.vocab_size, prompt_len)
    s_max = prompt_len + N_DECODE
    logits, cache = jax.jit(jspmd.make_prefill_step(jcfg, s_max))(
        params, {"tokens": jnp.asarray(toks)})
    out = {"prefill_logits": np.asarray(logits), "prefill_cache": jax.tree.map(np.asarray, cache)}
    decode = jax.jit(jspmd.make_decode_step(jcfg))
    tok = jnp.argmax(logits, -1)
    steps = []
    for i in range(N_DECODE):
        logits, cache = decode(params, cache, tok, jnp.asarray(prompt_len + i, jnp.int32))
        tok = jnp.argmax(logits, -1)
        steps.append((np.asarray(tok), np.asarray(logits)))
    out["steps"] = steps
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    return out


def _prompts(vocab, prompt_len):
    return np.random.default_rng(prompt_len).integers(0, vocab, size=(2, prompt_len))


def _port_params(name):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, _jax_weights(name)))


def _check_cache(got, want):
    """Each unit position's cache: {"k", "v"} of an attention layer, {"ssm",
    "conv"} of a mamba2 layer, in the JAX package's shapes and dtypes."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype), key
            np.testing.assert_allclose(g[key].numpy(), w[key], **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("prompt_len", [64, 200])
def test_prefill_matches_jax(name, prompt_len):
    _, cfg = _cfgs(name)
    want = _jax_run(name, prompt_len)
    toks = torch.from_numpy(_prompts(cfg.vocab_size, prompt_len))
    logits, cache = transformer.prefill(_port_params(name), cfg, toks, prompt_len + N_DECODE)
    assert tuple(logits.shape) == want["prefill_logits"].shape  # the padded head, as JAX's
    np.testing.assert_allclose(logits.numpy(), want["prefill_logits"], **TOL)
    _check_cache(cache, want["prefill_cache"])


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("prompt_len", [64, 200])
def test_greedy_decode_matches_jax(name, prompt_len):
    _, cfg = _cfgs(name)
    want = _jax_run(name, prompt_len)
    params = _port_params(name)
    toks = torch.from_numpy(_prompts(cfg.vocab_size, prompt_len))
    logits, cache = transformer.prefill(params, cfg, toks, prompt_len + N_DECODE)
    tok = torch.argmax(logits, -1)
    for i, (j_tok, j_logits) in enumerate(want["steps"]):
        logits, cache = transformer.decode_step(params, cfg, cache, tok, prompt_len + i)
        tok = torch.argmax(logits, -1)
        assert logits.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), j_logits, **TOL)
        assert np.array_equal(tok.numpy(), j_tok), (i, tok, j_tok)
    _check_cache(cache, want["final_cache"])


@pytest.mark.parametrize("prompt_len", [64, 200])
def test_bf16_prefill_and_first_decode_token_match_jax(prompt_len):
    """bf16 prefill logits within BF16_REL_NORM of the JAX package's, the
    same last-token argmax, and the same token from the first decode step.
    Later greedy tokens may part: a ~1% perturbation flips a near-tie of the
    two best logits. Here (B=2) all 16 tokens agreed at S=64 and S=200; in
    an earlier run at B=4, S=200 one of four sequences parted at step 4."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs("phi3"))
    params = jspmd.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _prompts(cfg.vocab_size, prompt_len)
    s_max = prompt_len + 1
    jl, jc = jax.jit(jspmd.make_prefill_step(jcfg, s_max))(params, {"tokens": jnp.asarray(toks)})
    p = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    pl, pc = transformer.prefill(p, cfg, torch.from_numpy(toks), s_max)
    assert pl.dtype == torch.bfloat16
    got, want = pl.float().numpy(), np.asarray(jl, np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL_NORM
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    jt = jnp.argmax(jl, -1)
    jl, _ = jax.jit(jspmd.make_decode_step(jcfg))(params, jc, jt, jnp.asarray(prompt_len,
                                                                              jnp.int32))
    pl, _ = transformer.decode_step(p, cfg, pc, torch.from_numpy(np.array(jt)), prompt_len)
    assert np.array_equal(torch.argmax(pl, -1).numpy(), np.asarray(jnp.argmax(jl, -1)))


def test_forward_matches_jax():
    """The full-sequence forward with its cache (the padded columns masked)."""
    from repro.models import transformer as jtransformer

    jcfg, cfg = _cfgs("minicpm")
    toks = _prompts(cfg.vocab_size, 48)
    jl, _, jc = jtransformer.forward(_jax_weights("minicpm"), jcfg, jnp.asarray(toks),
                                     return_cache=True)
    tl, aux, tc = transformer.forward(_port_params("minicpm"), cfg, torch.from_numpy(toks),
                                      return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0 and (tl[..., cfg.vocab_size:] == -1e30).all()
    _check_cache(tc, jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_forward_matches_jax(name):
    """The full-sequence forward of each new family with its cache and the
    MoE layers' summed load-balance loss, at the trajectory tolerance."""
    from repro.models import transformer as jtransformer

    jcfg, cfg = _cfgs(name)
    toks = _prompts(cfg.vocab_size, 48)
    jl, jaux, jc = jtransformer.forward(_jax_weights(name), jcfg, jnp.asarray(toks),
                                        return_cache=True)
    tl, aux, tc = transformer.forward(_port_params(name), cfg, torch.from_numpy(toks),
                                      return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TRAJ)
    np.testing.assert_allclose(float(aux), float(jaux), **TRAJ)
    assert (float(aux) > 0) == (cfg.moe is not None)
    _check_cache(tc, jax.tree.map(np.asarray, jc))


def test_prefill_attention_goes_through_the_wrapper(monkeypatch):
    """Every prefill attention layer calls ``gqa_attention_op`` once (on the
    card that is K9); decode calls it never."""
    calls = []
    real = layers.gqa_attention_op

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(layers, "gqa_attention_op", spy)
    _, cfg = _cfgs("phi3")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = serve.generate(params, cfg, serve.make_prompts(cfg, 2, 40, seed=0), 4)
    assert out["tokens"].shape == (2, 4)
    hd = cfg.resolved_head_dim
    assert calls == [((2, 40, cfg.n_heads, hd), (2, 40, cfg.n_kv_heads, hd), True)] * cfg.n_layers


def test_init_params_layout_matches_jax():
    """Same tree, same shapes and dtypes as the JAX package's init."""
    for name in ARCHS:
        jcfg, cfg = _cfgs(name)
        want = jax.tree.map(np.asarray, _jax_weights(name))
        got = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        got_leaves = interop.tree_to_numpy(got)
        for path, w in want_leaves:
            g = got_leaves
            for key in path:
                g = g[key.key if hasattr(key, "key") else key.idx]
            assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
        assert transformer.n_params(got) == sum(w.size for _, w in want_leaves)


def test_bf16_weights_carry_across():
    jcfg, cfg = _cfgs("phi3")
    jw = jspmd.init_params(dataclasses.replace(jcfg, dtype="bfloat16"), jax.random.PRNGKey(1))
    tw = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jw))
    a = tw["unit"][0]["mixer"]["wq"]
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.float().numpy(),
                                  np.asarray(jw["unit"][0]["mixer"]["wq"], np.float32))


def test_serve_cli_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--arch", "phi3-medium-14b", "--batch", "2",
                      "--prompt-len", "24", "--gen", "5"])
    assert out["tokens"].shape == (2, 5) and out["logits_finite"]
    assert out["prefill_ms"] > 0 and out["decode_tok_s"] > 0
    text = capsys.readouterr().out
    assert "phi3-medium-14b (reduced, float32" in text and "first sequence:" in text
    assert f"(median of {serve.TIMED_PREFILLS}: " in text


def test_warmup_runs_the_timed_shape_and_reps_repeat_the_prefill(monkeypatch):
    """The warm-up prefills the prompts at their own shape; ``prefill_reps``
    timed prefills give the same tokens as one, and the median of their times."""
    _, cfg = _cfgs("phi3")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = serve.make_prompts(cfg, 2, 40, seed=0)
    shapes = []
    real = transformer.prefill

    def spy(params, cfg, tokens, s_max, **kw):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, s_max, **kw)

    monkeypatch.setattr(transformer, "prefill", spy)
    serve.warmup(params, cfg, prompts)
    assert shapes == [(2, 40)]
    once = serve.generate(params, cfg, prompts, 4)
    three = serve.generate(params, cfg, prompts, 4, prefill_reps=3)
    assert len(shapes) == 1 + 1 + 3 and len(three["prefill_s_all"]) == 3
    assert three["prefill_s"] == float(np.median(three["prefill_s_all"]))
    assert torch.equal(once["tokens"], three["tokens"])
    torch.testing.assert_close(once["last_logits"], three["last_logits"], rtol=0, atol=0)


def test_serve_cli_is_deterministic():
    argv = ["--device", "cpu", "--arch", "minicpm-2b", "--batch", "2", "--prompt-len", "16",
            "--gen", "4", "--seed", "3"]
    assert np.array_equal(serve.main(argv)["tokens"], serve.main(argv)["tokens"])


def test_decode_attends_only_to_filled_positions():
    """Zeros past ``pos`` in the cache (what the reference masks) change
    nothing: garbage there must not either."""
    _, cfg = _cfgs("phi3")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = serve.make_prompts(cfg, 2, 20, seed=0)
    logits, cache = transformer.prefill(params, cfg, toks, 32)
    tok = torch.argmax(logits, -1)
    want, _ = transformer.decode_step(params, cfg, tuple(
        {k: t.clone() for k, t in c.items()} for c in cache), tok, 20)
    for c in cache:
        for t in c.values():
            t[:, :, 21:] = 1e4
    got, _ = transformer.decode_step(params, cfg, cache, tok, 20)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", [None, "jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b",
                                  "kimi-k2-1t-a32b", "llava-next-34b", "whisper-base"],
                         ids=["default", "jamba", "phi35moe", "kimi", "llava", "whisper"])
def test_serve_cli_serves_each_family(arch, capsys):
    """The launcher's default arch (mamba2-780m, reduced) and the other
    families, on the CPU: llava with its image prefix, whisper with its
    frames."""
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "24", "--gen", "4"]
    out = serve.main(argv + ([] if arch is None else ["--arch", arch]))
    assert out["tokens"].shape == (2, 4) and out["logits_finite"]
    assert f"{arch or 'mamba2-780m'} (reduced, float32" in capsys.readouterr().out


def test_windowed_prefill_beyond_a_query_chunk_matches_jax():
    """CONFIG_SWA as ``reduced()`` cuts it (window 64) at S=1100: two query
    chunks of 550, each far beyond the window; then two greedy steps."""
    jcfg, cfg = _cfgs("phi3_swa")
    toks = _prompts(cfg.vocab_size, 1100)
    params = _jax_weights("phi3_swa")
    jl, jc = jax.jit(jspmd.make_prefill_step(jcfg, 1102))(params, {"tokens": jnp.asarray(toks)})
    p = _port_params("phi3_swa")
    tl, tc = transformer.prefill(p, cfg, torch.from_numpy(toks), 1102)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, jax.tree.map(np.asarray, jc))
    decode = jax.jit(jspmd.make_decode_step(jcfg))
    jt, tt = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    for i in range(2):
        jl, jc = decode(params, jc, jt, jnp.asarray(1100 + i, jnp.int32))
        tl, tc = transformer.decode_step(p, cfg, tc, tt, 1100 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jt, tt = jnp.argmax(jl, -1), torch.argmax(tl, -1)
        assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_windowed_prefill_does_not_take_the_flash_attention_wrapper(monkeypatch):
    """K9 has no window: a windowed prefill never calls its wrapper."""
    calls = []
    monkeypatch.setattr(layers, "gqa_attention_op", lambda *a, **k: calls.append(1))
    _, cfg = _cfgs("phi3_swa")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits, _ = transformer.prefill(params, cfg, serve.make_prompts(cfg, 1, 100, seed=0), 101)
    assert not calls and torch.isfinite(logits).all()


def test_sliding_window_masks_history():
    """As the JAX package's test of the same name (``tests/test_models.py:132``):
    logits beyond the layers' reach of the perturbed tokens do not move."""
    cfg = dataclasses.replace(reduced(get_config("phi3-medium-14b")), sliding_window=8)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    t1 = serve.make_prompts(cfg, 1, 32, seed=4)
    t2 = t1.clone()
    t2[:, :8] = (t1[:, :8] + 7) % cfg.vocab_size
    l1, _ = transformer.forward(params, cfg, t1)
    l2, _ = transformer.forward(params, cfg, t2)
    horizon = 7 + cfg.n_layers * (cfg.sliding_window - 1) + 1
    torch.testing.assert_close(l1[:, horizon:], l2[:, horizon:], rtol=0, atol=1e-4)
    assert float((l1[:, :8] - l2[:, :8]).abs().max()) > 1e-3


def test_bf16_family_weights_carry_across():
    """A bf16 jamba tree: the mamba2 mixer's A_log, dt_bias and D and the MoE
    router stay f32 beside bf16 weights, each carried bitwise."""
    jcfg, cfg = _cfgs("jamba")
    jw = jspmd.init_params(dataclasses.replace(jcfg, dtype="bfloat16"), jax.random.PRNGKey(1))
    tw = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jw))
    mixer, ffn = tw["unit"][0]["mixer"], tw["unit"][1]["ffn"]
    assert {mixer[k].dtype for k in ("A_log", "dt_bias", "D")} == {torch.float32}
    assert ffn["router"].dtype == torch.float32
    assert mixer["in_proj"].dtype == ffn["w_gate"].dtype == torch.bfloat16
    got = [x.float().numpy() for x in T.leaves(tw)]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jw)]
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
