"""The port's vision frontend (llava-next-34b: the projector and the
image-prefix embeddings of ``models/transformer.py``) against the JAX
package's, on the same weights and inputs.

Weights are drawn by the JAX package (``spmd.init_params``) and carried
across as numpy (``interop.lm_params_from_numpy``), the projector with
them; the prefix embeddings (B, 16, d) x 0.1 and the tokens are made with
numpy. The config is llava-next-34b reduced (2 layers, d_model 256, 4
query heads on 4 KV heads of 64, a 16-position prefix, f32); one case
keeps GQA (4 on 2). Whole passes, gradients and training steps are held at
the trajectory tolerance ``rtol=1e-4, atol=1e-5``
(``tests/test_flatspace.py:233``), serving as ``tests/test_torch_serve.py``
holds it (2e-4).
"""
import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import algorithms as jalgorithms  # noqa: E402
from repro.core import spmd as jspmd  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import algorithms, spmd  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "llava-next-34b"
B, S_TEXT, N_DECODE = 2, 32, 8


def _cfgs(**kw):
    return (dataclasses.replace(jreduced(jget_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


@functools.lru_cache(maxsize=None)
def _jax_weights(n_kv_heads=None):
    kw = {} if n_kv_heads is None else {"n_kv_heads": n_kv_heads}
    return jspmd.init_params(_cfgs(**kw)[0], jax.random.PRNGKey(0))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree))


def _close(got, want, tol=TRAJ):
    got, want = T.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32), **tol)


def _inputs(cfg, b=B, s=S_TEXT, seed=0):
    rng = np.random.default_rng(seed)
    pe = (rng.standard_normal((b, cfg.frontend.n_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return pe, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_init_params_draws_the_projector():
    """The tree has the reference's keys, the (d, d) projector among them,
    and the same shapes and dtypes."""
    _, cfg = _cfgs()
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, _jax_weights()))
    got = interop.tree_to_numpy(transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                                        device="cpu"))
    assert got["projector"]["w"].shape == (cfg.d_model, cfg.d_model)
    for path, w in want:
        g = got
        for key in path:
            g = g[key.key if hasattr(key, "key") else key.idx]
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert len(T.leaves(got)) == len(want)


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_forward_with_prefix_matches_jax(n_kv_heads):
    """``forward`` with ``prefix_embeds``: cast, projected, prepended, the
    positions running over the whole sequence; logits and cache."""
    kw = {} if n_kv_heads is None else {"n_kv_heads": n_kv_heads}
    jcfg, cfg = _cfgs(**kw)
    jp = _jax_weights(n_kv_heads)
    pe, toks = _inputs(cfg)
    jl, _, jc = jtransformer.forward(jp, jcfg, jnp.asarray(toks), prefix_embeds=jnp.asarray(pe),
                                     return_cache=True)
    tl, aux, tc = transformer.forward(_port(jp), cfg, torch.from_numpy(toks).long(),
                                      prefix_embeds=torch.from_numpy(pe), return_cache=True)
    assert tuple(tl.shape) == (B, cfg.frontend.n_tokens + S_TEXT, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TRAJ)
    _close(tc, jc)


def test_loss_and_grads_with_prefix_match_jax():
    """``loss_fn`` drops the prefix's hidden rows; the loss and every
    gradient, the projector's included, with and without remat."""
    jcfg, cfg = _cfgs()
    jp = _jax_weights()
    pe, toks = _inputs(cfg, s=24)
    jbatch = {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pe)}
    jl, jg = jax.value_and_grad(lambda p: jtransformer.loss_fn(p, jcfg, jbatch, remat=True))(jp)
    assert float(jnp.abs(jg["projector"]["w"]).max()) > 0
    for remat in (False, True):
        live = T.map(lambda a: a.requires_grad_(), _port(jp))
        tl = transformer.loss_fn(live, cfg, {"tokens": torch.from_numpy(toks).long(),
                                             "prefix_embeds": torch.from_numpy(pe)}, remat=remat)
        grads = torch.autograd.grad(tl, T.leaves(live))
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TRAJ)
        _close(T.unflatten(live, list(grads)), jg)


def test_prefill_then_decode_matches_forward():
    """The reference's vlm branch of ``test_decode_matches_forward``
    (``tests/test_models.py:63-92``) on the port: prefill the image prefix
    and the first 16 tokens, the last logits against ``forward``'s at
    position ``n_prefix + 15`` (atol 2e-3, the reference's bound); then the
    other 16 tokens decoded one by one at ``n_prefix + t`` against
    ``forward`` (atol 5e-4, the reference's decode bound)."""
    _, cfg = _cfgs()
    p = _port(_jax_weights())
    pe, toks = _inputs(cfg, seed=1)
    n_prefix = cfg.frontend.n_tokens
    tt, tpe = torch.from_numpy(toks).long(), torch.from_numpy(pe)
    logits, _ = transformer.forward(p, cfg, tt, prefix_embeds=tpe)
    last, cache = transformer.prefill(p, cfg, tt[:, :16], S_TEXT + n_prefix, prefix_embeds=tpe)
    np.testing.assert_allclose(last.numpy(), logits[:, n_prefix + 15].numpy(), atol=2e-3)
    for t in range(16, S_TEXT):
        lg, cache = transformer.decode_step(p, cfg, cache, tt[:, t], n_prefix + t)
        np.testing.assert_allclose(lg.numpy(), logits[:, n_prefix + t, : cfg.vocab_size].numpy(),
                                   atol=5e-4)


def test_spmd_prefill_and_greedy_decode_match_jax():
    """``spmd``'s prefill with ``batch["prefix_embeds"]`` and 8 greedy steps
    from position ``n_prefix + S``, each against the JAX package's jitted
    steps, as the two serve launchers run them."""
    jcfg, cfg = _cfgs()
    jp = _jax_weights()
    pe, toks = _inputs(cfg)
    n_prefix = cfg.frontend.n_tokens
    s_max = n_prefix + S_TEXT + N_DECODE
    jl, jc = jax.jit(jspmd.make_prefill_step(jcfg, s_max))(
        jp, {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pe)})
    tp = _port(jp)
    tl, tc = spmd.make_prefill_step(cfg, s_max)(
        tp, {"tokens": torch.from_numpy(toks).long(), "prefix_embeds": torch.from_numpy(pe)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close(tc, jc, TOL)
    jdec, tdec = jax.jit(jspmd.make_decode_step(jcfg)), spmd.make_decode_step(cfg)
    jt, tt = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    for i in range(N_DECODE):
        pos = n_prefix + S_TEXT + i
        jl, jc = jdec(jp, jc, jt, jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(tp, tc, tt, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jt, tt = jnp.argmax(jl, -1), torch.argmax(tl, -1)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
    _close(tc, jc, TOL)


def test_serve_generate_offsets_decode_by_the_prefix():
    """``serve.generate`` with the frontend's prefix: the cache holds P + S +
    n_gen positions, and its tokens are ``spmd``'s prefill and greedy steps
    from position P + S."""
    _, cfg = _cfgs()
    p = _port(_jax_weights())
    prompts = serve.make_prompts(cfg, B, 20, seed=0)
    front = serve.make_frontend(cfg, B, 0)
    out = serve.generate(p, cfg, prompts, 4, frontend=front)
    n_prefix = cfg.frontend.n_tokens
    logits, cache = transformer.prefill(p, cfg, prompts, n_prefix + 24,
                                        prefix_embeds=front["prefix_embeds"])
    assert tuple(cache[0]["k"].shape[1:3]) == (B, n_prefix + 24)
    tok, toks = torch.argmax(logits, -1), []
    for i in range(4):
        toks.append(tok)
        if i < 3:
            lg, cache = transformer.decode_step(p, cfg, cache, tok, n_prefix + 20 + i)
            tok = torch.argmax(lg, -1)
    assert torch.equal(out["tokens"], torch.stack(toks, 1))


@pytest.mark.parametrize("algo", ["easgd", "ma"])
def test_shadow_step_and_sync_with_prefix_match_jax(algo):
    """One shadow train step (R=2, SGD) on {tokens, prefix_embeds} and one
    sync of ``algo``, against the JAX package's jitted steps; the
    projector's gradient moves it."""
    jcfg, cfg = _cfgs()
    R = 2
    jp = _jax_weights()
    rng = np.random.default_rng(4)
    pe = (rng.standard_normal((R, 2, cfg.frontend.n_tokens, cfg.d_model)) * 0.1).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (R, 2, 24)).astype(np.int32)
    jsc = jsync.SyncConfig(algo=algo, alpha=0.5).validate()
    jalgo = jalgorithms.get(algo).init_state(jp, jsc)
    jstack = jax.tree.map(jnp.copy, jspmd.stack_replicas(jp, R))
    jstack, _, jloss = jax.jit(jspmd.make_train_step(jcfg, joptim.sgd(0.1), "shadow"))(
        jstack, (), {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pe)})
    jstack, jalgo = jax.jit(jspmd.make_sync_step(jcfg, jsc))(jstack, jalgo)
    tp = _port(jp)
    sc = SyncConfig(algo=algo, alpha=0.5).validate()
    talgo = algorithms.get(algo).init_state(tp, sc)
    stack = spmd.stack_replicas(tp, R)
    stack, _, loss = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")(
        stack, (), {"tokens": torch.from_numpy(toks).long(), "prefix_embeds": torch.from_numpy(pe)})
    stack, talgo = spmd.make_sync_step(cfg, sc)(stack, talgo)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TRAJ)
    _close(stack, jstack)
    assert not torch.equal(stack["projector"]["w"][0], tp["projector"]["w"])
    if algo == "easgd":
        _close(talgo, jalgo)


def test_tokens_alone_leave_the_projector_unmoved_as_in_jax():
    """Trained on tokens alone (the ``lm`` launcher's batches, as the
    reference's ``run_lm``) the projector is unread: a zero gradient, as
    under ``jax.grad``, and the step matches the JAX package's."""
    jcfg, cfg = _cfgs()
    jp = _jax_weights()
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 2, 24)).astype(np.int32)
    jstack = jax.tree.map(jnp.copy, jspmd.stack_replicas(jp, 2))
    jstack, _, jloss = jax.jit(jspmd.make_train_step(jcfg, joptim.sgd(0.1), "shadow"))(
        jstack, (), {"tokens": jnp.asarray(toks)})
    stack = spmd.stack_replicas(_port(jp), 2)
    stack, _, loss = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")(
        stack, (), {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TRAJ)
    _close(stack, jstack)
    assert torch.equal(stack["projector"]["w"][1], _port(jp)["projector"]["w"])


def test_example_trains_llava_on_prefix_embeddings():
    """``examples/torch_lm_shadowsync.py`` feeds stubbed patch embeddings."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch_lm_shadowsync.py")
    spec = importlib.util.spec_from_file_location("torch_lm_shadowsync_v", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        losses = mod.main(["--device", "cpu", "--arch", ARCH, "--iters", "6"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert f"{ARCH}:" in out.getvalue()
