"""The port's LM serving path (prefill + greedy decode) against the JAX
package's, on the same weights and prompts.

The JAX weights (``spmd.init_params`` on a reduced config, f32) are carried
across as numpy with ``interop.lm_params_from_numpy``; the JAX steps run
jitted on the CPU, as its launcher runs them. Reduced phi3-medium-14b keeps
GQA (4 query heads on 2 KV heads); reduced minicpm-2b is MHA with tied
embeddings, and its vocab is cut to 500 so the head is padded to 512;
phi3 with a 64-token sliding window runs the plain attention path (on the
CPU only: the card refuses a window); reduced granite-20b is MQA (4 query
heads on 1 KV head). A bf16 reduced phi3 is held to the JAX package at a
bound set for bf16 rounding.
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
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
N_DECODE = 8
# (arch, the reduced config's overrides)
ARCHS = {"phi3": ("phi3-medium-14b", dict(n_kv_heads=2)),
         "minicpm": ("minicpm-2b", dict(vocab_size=500)),
         # the CPU's plain path for a window (CONFIG_SWA's, cut as reduced() cuts it)
         "phi3_swa": ("phi3-medium-14b", dict(n_kv_heads=2, sliding_window=64)),
         # MQA, as granite-20b and -34b: every query head on one KV head
         "granite": ("granite-20b", {})}
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
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("k", "v"):
            assert tuple(g[key].shape) == w[key].shape
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

    def spy(params, cfg, tokens, s_max):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, s_max)

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


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b", "kimi-k2-1t-a32b",
                                  "llava-next-34b", "whisper-base", "phi3.5-moe-42b-a6.6b"])
def test_serve_refuses_unported_families(arch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve.main(["--device", "cpu", "--arch", arch, "--prompt-len", "8", "--gen", "2"])
