"""The two §Perf variants of the reference (``tests/test_perf_variants.py``)
on the port, against the JAX package on the same weights and tokens:
``remat_policy="save_comm"`` (a selective checkpoint that keeps each unit's
attention and FFN outputs) and ``parallel_block`` (PaLM's block: one
shared pre-norm, attention and FFN added together).

The JAX weights are drawn by its ``spmd.init_params`` on reduced configs
(f32) and carried across as numpy (``interop.lm_params_from_numpy``); the
JAX functions run jitted on the CPU. The kernel tolerance is ``rtol=1e-5,
atol=1e-6`` (``tests/test_flatspace.py:23``), the trajectory one
``rtol=1e-4, atol=1e-5`` (:233). A whole model's outputs across the two
frameworks meet the trajectory tolerance, not the kernel one, with or
without ``parallel_block``: at these reduced widths the sequential block's
logits part by up to 4.9e-6 (597-620 of 49,152 outside the kernel
tolerance), the parallel block's by up to 3.8e-6, each framework summing
its products in its own order. ``tests/test_torch_lm_train.py`` holds
losses and gradients at the trajectory tolerance for the same reason.
"""
import dataclasses
import functools

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
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

KERNEL = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)
# tests/test_torch_lm_train.py's rule under Adam: at most this share of a
# leaf's weights may part from JAX's by more than TRAJ (Adam's step is
# scale-free, so a weight whose gradient is of the order of its rounding
# steps by up to lr either way), and those within two steps of lr
ADAM_STRAY = 1e-4
# parallel_block on a dense arch with GQA, and on the MoE arch
ARCHS = {"phi3": ("phi3-medium-14b", dict(n_kv_heads=2)), "phi35moe": ("phi3.5-moe-42b-a6.6b", {})}


def _cfgs(arch, parallel=False, **kw):
    return (dataclasses.replace(jreduced(jget_config(arch)), parallel_block=parallel, **kw),
            dataclasses.replace(reduced(get_config(arch)), parallel_block=parallel, **kw))


@functools.lru_cache(maxsize=None)
def _jax_weights(arch, seed, parallel=False, **kw):
    jcfg, _ = _cfgs(arch, parallel, **kw)
    return jspmd.init_params(jcfg, jax.random.PRNGKey(seed))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree))


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    got, want = T.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32), **tol)


def _grads(params, cfg, toks, **kw):
    params = T.map(lambda a: a.detach().clone().requires_grad_(), params)
    loss = transformer.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks).long()}, **kw)
    grads = torch.autograd.grad(loss, T.leaves(params), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), T.unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# remat_policy="save_comm"
# ---------------------------------------------------------------------------

def test_save_comm_gradients_follow_jax():
    """Reduced granite-20b: the port's ``save_comm`` loss and gradients
    against the JAX package's ``save_comm`` ones, on its weights."""
    jcfg, cfg = _cfgs("granite-20b")
    jp = _jax_weights("granite-20b", 0)
    toks = _tokens(cfg.vocab_size, 2, 32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}, remat=True,
                             remat_policy="save_comm")))(jp)
    loss, grads = _grads(_port(jp), cfg, toks, remat=True, remat_policy="save_comm")
    np.testing.assert_allclose(float(loss), float(j_loss), **KERNEL)
    _close(grads, j_grads, KERNEL)


@pytest.mark.parametrize("seq", [32, 1100], ids=["one_chunk", "two_query_chunks"])
@pytest.mark.parametrize("arch", ["granite-20b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                                  "mamba2-780m", "jamba-1.5-large-398b"])
def test_save_comm_matches_full_remat(arch, seq):
    """What is stored changes, not what is computed: the loss and every
    gradient bitwise those of full remat, but the embedding table's (an
    indexed accumulation over repeated tokens, whose order is not fixed on
    the CPU), held at the kernel tolerance. At 1,100 tokens the training
    attention's own query chunks are rematerialised inside the unit."""
    if seq > 32 and arch != "granite-20b":
        seq = 64  # the families' layers at a second length, without the long chunking
    _, cfg = _cfgs(arch)
    params = _port(_jax_weights(arch, 0))
    toks = _tokens(cfg.vocab_size, 2, seq)
    full = _grads(params, cfg, toks, remat=True)
    comm = _grads(params, cfg, toks, remat=True, remat_policy="save_comm")
    assert torch.equal(full[0], comm[0])
    for (path, a), b in zip(T.leaves_with_path(full[1]), T.leaves(comm[1])):
        if path == "embed/table":
            torch.testing.assert_close(a, b, **KERNEL)
        else:
            assert torch.equal(a, b), path


def test_save_comm_keeps_the_named_outputs():
    """The policy keeps, per unit, each sequential layer's output products
    (``wo`` or ``out_proj``, and every ``w_down``: the MoE experts' ``bmm``
    and its shared expert's) and a parallel layer's sum, and nothing
    else."""
    import torch.utils.checkpoint as C

    kept = []
    real = C.create_selective_checkpoint_contexts

    def watched(policy, *a, **kw):
        def pol(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            if out == C.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                kept.append(str(op))
            return out

        return real(pol, *a, **kw)

    C.create_selective_checkpoint_contexts = watched
    try:
        for arch, parallel, want in [
                ("granite-20b", False, ["aten.mm.default"] * 4),
                ("kimi-k2-1t-a32b", False, ["aten.mm.default", "aten.bmm.default",
                                            "aten.mm.default"] * 2),
                ("jamba-1.5-large-398b", False, ["aten.mm.default", "aten.mm.default",
                                                 "aten.mm.default", "aten.bmm.default"]),
                ("phi3.5-moe-42b-a6.6b", True, ["aten.add.Tensor"] * 2),
                ("jamba-1.5-large-398b", True, ["aten.mm.default", "aten.mm.default",
                                                "aten.add.Tensor"])]:
            kept.clear()
            _, cfg = _cfgs(arch, parallel)
            params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            _grads(params, cfg, _tokens(cfg.vocab_size, 2, 16), remat=True,
                   remat_policy="save_comm")
            assert kept == want, (arch, parallel, kept)
    finally:
        C.create_selective_checkpoint_contexts = real


def test_save_comm_recompute_skips_the_mixer_products():
    """The backward pass's recompute runs each unit's ``wo`` product under
    full remat and not under ``save_comm``; it never reaches a unit's last
    product (the FFN's ``w_down``) under either, since the non-reentrant
    recompute stops at the last tensor the backward pass needs."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.shapes[tuple(tuple(a.shape) for a in args)] += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs("granite-20b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, 32)).long()}
    seen = {}
    for policy in ("full", "save_comm"):
        p = T.map(lambda a: a.detach().clone().requires_grad_(), params)
        loss = transformer.loss_fn(p, cfg, toks, remat=True, remat_policy=policy)
        with Products() as m:
            torch.autograd.grad(loss, T.leaves(p))
        seen[policy] = m.shapes
    hd = cfg.n_heads * cfg.resolved_head_dim
    assert seen["full"] - seen["save_comm"] == {((64, hd), (hd, cfg.d_model)): cfg.n_layers}
    assert not seen["save_comm"] - seen["full"]


def test_remat_policy_names():
    _, cfg = _cfgs("granite-20b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="unknown remat policy"):
        transformer.loss_fn(params, cfg, {"tokens": toks}, remat=True, remat_policy="save_all")
    with pytest.raises(ValueError, match="unknown remat policy"):
        spmd.make_train_step(cfg, optim.sgd(0.1), "shadow", remat_policy="offload")


# ---------------------------------------------------------------------------
# parallel_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_parallel_forward_loss_and_grads_follow_jax(name):
    """The full-sequence form, ``x + (mixed + y)``: logits and aux (the
    prefill form, the plain K9 version on the CPU), the loss and every
    gradient (the training form), the unused ``norm2``'s gradient zeros."""
    arch, kw = ARCHS[name]
    jcfg, cfg = _cfgs(arch, True, **kw)
    jp = _jax_weights(arch, 2, True, **kw)
    toks = _tokens(cfg.vocab_size, 2, 48, seed=2)
    j_logits, j_aux = jax.jit(lambda p: jT.forward(p, jcfg, jnp.asarray(toks)))(jp)
    logits, aux = transformer.forward(_port(jp), cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TRAJ)
    np.testing.assert_allclose(float(aux), float(j_aux), **TRAJ)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}, remat=True)))(jp)
    loss, grads = _grads(_port(jp), cfg, toks, remat=True)
    np.testing.assert_allclose(float(loss), float(j_loss), **TRAJ)
    _close(grads, j_grads, TRAJ)
    assert all(not g.any() for g in T.leaves([u["norm2"] for u in grads["unit"]]))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_parallel_prefill_and_decode_follow_jax(name):
    """``prefill`` (its logits and the whole cache) and 4 greedy decode
    steps, each in the reference's summation order ((x + mixed) + y in
    decode)."""
    arch, kw = ARCHS[name]
    jcfg, cfg = _cfgs(arch, True, **kw)
    jp = _jax_weights(arch, 2, True, **kw)
    toks = _tokens(cfg.vocab_size, 2, 40, seed=3)
    s_max = 40 + 4
    j_logits, j_cache = jax.jit(jspmd.make_prefill_step(jcfg, s_max))(
        jp, {"tokens": jnp.asarray(toks)})
    params = _port(jp)
    with torch.no_grad():
        logits, cache = transformer.prefill(params, cfg, torch.from_numpy(toks).long(), s_max)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TRAJ)
    _close(cache, j_cache, TRAJ)
    decode = jax.jit(jspmd.make_decode_step(jcfg))
    j_tok, tok = jnp.argmax(j_logits, -1), logits.argmax(-1)
    for i in range(4):
        j_logits, j_cache = decode(jp, j_cache, j_tok, jnp.asarray(40 + i, jnp.int32))
        with torch.no_grad():
            logits, cache = transformer.decode_step(params, cfg, cache, tok, 40 + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TRAJ)
        j_tok, tok = jnp.argmax(j_logits, -1), logits.argmax(-1)
        assert np.array_equal(tok.numpy(), np.asarray(j_tok)), i
    _close(cache, j_cache, TRAJ)


def test_parallel_block_trains_as_jax_does():
    """The reference's ``test_parallel_block_trains``: reduced phi3.5-moe
    with ``parallel_block``, syncdp Adam 2e-3, 8 steps on one batch. Each
    loss at the trajectory tolerance, falling and finite; the weights at
    the trajectory tolerance but for ADAM_STRAY of a leaf, within 2·lr."""
    jcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b", True)
    jp = _jax_weights("phi3.5-moe-42b-a6.6b", 1, True)
    toks = _tokens(cfg.vocab_size, 2, 32, seed=1)
    jopt, opt = joptim.adam(2e-3), optim.adam(2e-3)
    jstep = jax.jit(jspmd.make_train_step(jcfg, jopt, "syncdp"))
    step = spmd.make_train_step(cfg, opt, "syncdp")
    params = _port(jp)
    st = opt.init(params)
    jst = jopt.init(jp)
    losses, j_losses = [], []
    for _ in range(8):
        jp, jst, j_loss = jstep(jp, jst, {"tokens": jnp.asarray(toks)})
        params, st, loss = step(params, st, {"tokens": torch.from_numpy(toks).long()})
        losses.append(float(loss))
        j_losses.append(float(j_loss))
    np.testing.assert_allclose(losses, j_losses, **TRAJ)
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    for a, b in zip(T.leaves(params), jax.tree.leaves(jp)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        stray = ~np.isclose(a, b, **TRAJ)
        assert stray.mean() <= ADAM_STRAY, (stray.sum(), a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 2e-3)
    _close(st["m"], jst["m"], TRAJ)
