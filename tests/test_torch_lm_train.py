"""The port's LM training path (``core/spmd.py``, ``transformer.loss_fn``,
the training form of attention, ``optim.update_in_place``, the ``lm``
launcher) against the JAX package's, on the same weights and batches.

The JAX weights and optimizer states are carried across as numpy
(``interop.lm_train_state_from_numpy``); the JAX steps run jitted on the
CPU, as its launcher runs them, on the JAX package's token batches. The
configs are reduced (2 layers, d_model 256, f32): phi3-medium-14b with GQA
(4 query heads on 2 KV heads), minicpm-2b (MHA, tied embeddings) and a
variant with vocab 500 whose head is padded to 512, granite-20b (MQA) and
phi3 with a 64-token sliding window; and the other families: mamba2-780m
(ssm), jamba-1.5-large (hybrid, MoE every other layer), phi3.5-moe and
kimi-k2 (MoE, kimi with a shared expert), whose loss adds the MoE layers'
load-balance ``aux``. The tolerance is the trajectory one,
``rtol=1e-4, atol=1e-5`` (``tests/test_flatspace.py:233``), unless a case's
docstring says otherwise.
"""
import dataclasses
import functools
import json

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
from repro.data import tokens as jtok  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
ALGOS = ("easgd", "ma", "bmuf", "gossip")
# (arch, the reduced config's overrides)
ARCHS = {"phi3": ("phi3-medium-14b", dict(n_kv_heads=2)),
         "minicpm": ("minicpm-2b", {}),
         "minicpm_pad": ("minicpm-2b", dict(vocab_size=500)),
         "granite": ("granite-20b", {}),
         # CONFIG_SWA's window, cut as reduced() cuts it
         "phi3_swa": ("phi3-medium-14b", dict(n_kv_heads=2, sliding_window=64)),
         "mamba2": ("mamba2-780m", {}),
         "jamba": ("jamba-1.5-large-398b", {}),
         "phi35moe": ("phi3.5-moe-42b-a6.6b", {}),
         "kimi": ("kimi-k2-1t-a32b", {})}
FAMILIES = ("mamba2", "jamba", "phi35moe", "kimi")
DENSE = tuple(a for a in ARCHS if a not in FAMILIES)
# S above the attention's q_chunk (1024) and not a multiple of it: 1100 is
# cut into two chunks of 550 (the largest divisor), and into three CE
# chunks of 512 with the last one padded
LONG_S = 1100


def _cfgs(name):
    arch, kw = ARCHS[name]
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


@functools.lru_cache(maxsize=None)
def _jax_weights(name, seed=0):
    jcfg, _ = _cfgs(name)
    return jspmd.init_params(jcfg, jax.random.PRNGKey(seed))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree))


def _close(got, want, tol=TRAJ):
    got, want = T.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32), **tol)


# Adam's step is m / sqrt(v): scale-free, so an element whose gradient is
# of the order of its rounding error steps by up to lr either way, whatever
# its size. The two packages' gradients agree at TRAJ
# (test_loss_and_grads_follow_jax), as do Adam's m and v after every run
# here; a few weights (at most 3.6e-5 of a leaf measured, 1.9e-4 apart at lr
# 1e-3) part by more than TRAJ. So under Adam the weights are held at TRAJ
# but for at most ADAM_STRAY of each leaf's elements, and those within two
# steps of lr (one step taken each way).
ADAM_STRAY = 1e-4


def _close_adam(got, want, lr):
    for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        stray = ~np.isclose(a, b, **TRAJ)
        assert stray.mean() <= ADAM_STRAY, (stray.sum(), a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)


def _close_params(got, want, opt_name, lr):
    if opt_name == "adam":
        _close_adam(got, want, lr)
    else:
        _close(got, want)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, remat):
    jcfg, _ = _cfgs(name)
    toks = _tokens(jcfg.vocab_size, 2, LONG_S)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, jcfg, b, remat=remat)))(
        _jax_weights(name), {"tokens": jnp.asarray(toks)})
    return toks, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_follow_jax(name, remat):
    toks, j_loss, j_grads = _jax_value_and_grad(name, remat)
    _, cfg = _cfgs(name)
    params = T.map(lambda a: a.requires_grad_(), _port(_jax_weights(name)))
    loss = transformer.loss_fn(params, cfg, {"tokens": torch.tensor(toks).long()},
                               remat=remat)
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), j_loss, **TRAJ)
    _close(T.unflatten(params, list(grads)), j_grads)
    if name == "minicpm_pad":  # the padded rows of the tied table get no gradient
        assert torch.equal(grads[0][cfg.vocab_size:], torch.zeros_like(grads[0][cfg.vocab_size:]))


def test_remat_recomputes_the_same_gradients():
    """Recomputation changes what is kept, not what is computed: the loss
    and every gradient bitwise, except the embedding table's. Its gradient
    is an indexed accumulation over repeated tokens, whose order is not
    fixed on the CPU (7e-9 apart here): it is held at the kernel tolerance
    (rtol 1e-5, atol 1e-6, ``tests/test_flatspace.py:23``)."""
    _, cfg = _cfgs("phi3")
    toks = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, LONG_S)).long()}
    out = []
    for remat in (False, True):
        params = T.map(lambda a: a.requires_grad_(), _port(_jax_weights("phi3")))
        loss = transformer.loss_fn(params, cfg, toks, remat=remat)
        out.append((loss, torch.autograd.grad(loss, T.leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    (table0, *rest0), (table1, *rest1) = out[0][1], out[1][1]
    assert all(torch.equal(a, b) for a, b in zip(rest0, rest1))
    torch.testing.assert_close(table0, table1, rtol=1e-5, atol=1e-6)


def test_forward_takes_the_form_it_is_asked_for():
    """The training form is the caller's choice: the prefill form's logits
    equal the training form's (the plain K9 version on the CPU against the
    chunked attention), remat needs the training form, and save_comm (a
    selective remat, ``tests/test_torch_perf_variants.py``) gives full
    remat's loss while an unknown policy raises."""
    _, cfg = _cfgs("minicpm")
    params = _port(_jax_weights("minicpm"))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 64)).long()
    a, _ = transformer.forward(params, cfg, toks)
    b, _ = transformer.forward(params, cfg, toks, train=True, remat=True)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="train=True"):
        transformer.forward(params, cfg, toks, remat=True)
    assert torch.equal(
        transformer.loss_fn(params, cfg, {"tokens": toks}, remat=True, remat_policy="save_comm"),
        transformer.loss_fn(params, cfg, {"tokens": toks}, remat=True))
    assert callable(spmd.make_train_step(cfg, optim.sgd(0.1), "shadow", remat_policy="save_comm"))
    with pytest.raises(ValueError, match="unknown remat policy"):
        spmd.make_train_step(cfg, optim.sgd(0.1), "shadow", remat_policy="save_most")


# ---------------------------------------------------------------------------
# make_train_step and the sync step against the JAX package
# ---------------------------------------------------------------------------

def _jax_setup(jcfg, params, opt, algo, R):
    stack = jax.tree.map(jnp.copy, jspmd.stack_replicas(params, R))
    ost = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (R,) + x.shape).copy(),
                       opt.init(params))
    sc = jsync.SyncConfig(algo=algo, alpha=0.5).validate()
    return stack, ost, sc, jalgorithms.get(algo).init_state(params, sc)


@functools.lru_cache(maxsize=None)
def _jax_shadow_run(algo, opt_name, lr, iters, gap, R, B, S):
    """The reference's ``run_lm`` loop (``repro/launch/train.py:327-340``) on
    reduced minicpm-2b: initial state, batches, per-replica losses and the
    final state, as numpy."""
    jcfg, _ = _cfgs("minicpm")
    params = _jax_weights("minicpm")
    opt = joptim.make(opt_name, lr)
    stack, ost, sc, astate = _jax_setup(jcfg, params, opt, algo, R)
    init = jax.tree.map(np.asarray, (stack, ost, astate))
    step = jax.jit(jspmd.make_train_step(jcfg, opt, "shadow"))
    sync = jax.jit(jspmd.make_sync_step(jcfg, sc))
    trans = jtok.make_transition(jcfg.vocab_size, seed=0)
    batches, losses = [], []
    for it in range(iters):
        b = jtok.gen_batch(trans, 0, it, B * R, S)
        batch = jax.tree.map(lambda x: x.reshape(R, B, *x.shape[1:]), b)
        batches.append(np.asarray(batch["tokens"]))
        stack, ost, loss = step(stack, ost, batch)
        losses.append(np.asarray(loss))
        if (it + 1) % gap == 0:
            stack, astate = sync(stack, astate)
    return init, batches, losses, jax.tree.map(np.asarray, (stack, ost, astate))


def _port_shadow_run(algo, opt_name, lr, gap, init, batches):
    _, cfg = _cfgs("minicpm")
    stack, ost, astate = interop.lm_train_state_from_numpy(*init[:2], algo, init[2])
    step = spmd.make_train_step(cfg, optim.make(opt_name, lr), "shadow")
    sync = spmd.make_sync_step(cfg, SyncConfig(algo=algo, alpha=0.5).validate())
    losses = []
    for it, toks in enumerate(batches):
        stack, ost, loss = step(stack, ost, {"tokens": torch.tensor(toks).long()})
        losses.append(loss)
        if (it + 1) % gap == 0:
            stack, astate = sync(stack, astate)
    return losses, (stack, ost, astate)


@pytest.mark.parametrize("opt_name,lr", [("sgd", 0.1), ("adam", 1e-3)], ids=["sgd", "adam"])
@pytest.mark.parametrize("algo", ALGOS)
def test_shadow_train_and_sync_steps_follow_jax(algo, opt_name, lr):
    """Ten shadow steps of R=2 replicas, the sync every five: every
    replica's loss, the final optimizer state and sync state at TRAJ, the
    final stack at TRAJ (under Adam as ``ADAM_STRAY`` says)."""
    init, batches, j_losses, j_final = _jax_shadow_run(algo, opt_name, lr, 10, 5, 2, 2, 64)
    losses, final = _port_shadow_run(algo, opt_name, lr, 5, init, batches)
    assert all(loss.shape == (2,) for loss in losses)
    np.testing.assert_allclose(torch.stack(losses).numpy(), np.stack(j_losses), **TRAJ)
    _close_params(final[0], j_final[0], opt_name, lr)
    _close(final[1], j_final[1])
    if algo == "gossip":
        assert final[2] == int(j_final[2]) == 2
    elif algo == "easgd":
        _close_params(final[2], j_final[2], opt_name, lr)
    elif algo == "bmuf":
        _close_params(final[2].w_global, j_final[2].w_global, opt_name, lr)
        _close_params(final[2].velocity, j_final[2].velocity, opt_name, lr)


@pytest.mark.parametrize("algo", ALGOS)
def test_run_lm_loop_follows_jax(algo):
    """The launcher's loop at its defaults (Adam 1e-3, R=2, batch 8, S=128,
    alpha 0.5, gap 5), rebuilt from each package's pieces on the JAX
    package's batches: every iteration's replica-mean loss, as ``run_lm``
    records it, for 10 iterations (two syncs)."""
    init, batches, j_losses, _ = _jax_shadow_run(algo, "adam", 1e-3, 10, 5, 2, 8, 128)
    losses, _ = _port_shadow_run(algo, "adam", 1e-3, 5, init, batches)
    np.testing.assert_allclose([float(x.mean()) for x in losses],
                               [float(np.mean(x)) for x in j_losses], **TRAJ)
    assert np.mean([float(x.mean()) for x in losses[-5:]]) < np.mean(
        [float(x.mean()) for x in losses[:5]])


@functools.lru_cache(maxsize=None)
def _jax_syncdp(k, grad_dtype, opt_name, lr):
    jcfg, _ = _cfgs("minicpm")
    params = _jax_weights("minicpm", seed=2)
    opt = joptim.make(opt_name, lr)
    toks = _tokens(jcfg.vocab_size, 8, 32, seed=2)
    step = jax.jit(jspmd.make_train_step(jcfg, opt, "syncdp", n_microbatches=k,
                                         grad_dtype=grad_dtype))
    st = opt.init(params)
    init = jax.tree.map(np.asarray, (params, st))
    p, losses = params, []
    for _ in range(3):
        p, st, loss = step(p, st, {"tokens": jnp.asarray(toks)})
        losses.append(float(loss))
    return init, toks, losses, jax.tree.map(np.asarray, (p, st))


def _port_syncdp(k, grad_dtype, opt_name, lr, init, toks):
    _, cfg = _cfgs("minicpm")
    p, st = _port(init[0]), _port(init[1])
    step = spmd.make_train_step(cfg, optim.make(opt_name, lr), "syncdp", n_microbatches=k,
                                grad_dtype=grad_dtype)
    losses = []
    for _ in range(3):
        p, st, loss = step(p, st, {"tokens": torch.tensor(toks).long()})
        losses.append(float(loss))
    return losses, (p, st)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("opt_name,lr", [("sgd", 1e-2), ("adam", 1e-3)], ids=["sgd", "adam"])
def test_syncdp_step_and_microbatches_follow_jax(k, opt_name, lr):
    """Three syncdp steps on one batch of 8, whole or in 4 microbatches
    (f32 accumulation): losses and optimizer state at TRAJ, parameters at
    TRAJ (under Adam as ``ADAM_STRAY`` says)."""
    init, toks, j_losses, j_final = _jax_syncdp(k, "float32", opt_name, lr)
    losses, final = _port_syncdp(k, "float32", opt_name, lr, init, toks)
    np.testing.assert_allclose(losses, j_losses, **TRAJ)
    _close_params(final[0], j_final[0], opt_name, lr)
    _close(final[1], j_final[1])


def test_microbatch_accumulation_matches_full_batch():
    """As the JAX package's test of the same name: K=4 accumulation equals
    one batch of 8 (every microbatch has the same token count, so the mean
    of means is the mean), at that test's bound (rtol 2e-4, atol 2e-5: the
    sums run in another order)."""
    init, toks, _, _ = _jax_syncdp(1, "float32", "sgd", 1e-2)
    l1, (p1, _) = _port_syncdp(1, "float32", "sgd", 1e-2, init, toks)
    l4, (p4, _) = _port_syncdp(4, "float32", "sgd", 1e-2, init, toks)
    np.testing.assert_allclose(l1[0], l4[0], rtol=1e-5)
    for a, b in zip(T.leaves(p1), T.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_bf16_gradient_accumulation_follows_jax():
    """K=4 microbatches summed in bf16, as the JAX package sums them, then
    SGD (lr 1e-2) on f32 weights. Both packages round each microbatch's f32
    gradient to bf16 and add in bf16 in the same order; a gradient that
    differs in its last f32 bits may round to a neighbouring bf16 value, so
    a step may differ by lr x one bf16 ulp of a gradient (< 1e-5 at these
    gradients), inside the trajectory tolerance."""
    init, toks, j_losses, j_final = _jax_syncdp(4, "bfloat16", "sgd", 1e-2)
    losses, final = _port_syncdp(4, "bfloat16", "sgd", 1e-2, init, toks)
    np.testing.assert_allclose(losses, j_losses, **TRAJ)
    _close(final[0], j_final[0])


# ---------------------------------------------------------------------------
# The in-place update and replica independence
# ---------------------------------------------------------------------------

def _random_tree(gen, R, dtype):
    return {"a": torch.randn((R, 6, 5), generator=gen).to(dtype),
            "b": (torch.randn((R, 7), generator=gen).to(dtype),
                  {"c": torch.randn((R, 3, 2, 2), generator=gen).to(dtype)})}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(optim.REGISTRY))
def test_update_in_place_is_bitwise_the_functional_update(name, dtype):
    """Three steps of ``update_in_place`` on each replica's slice of a
    stacked tree (views into the stacks) equal ``opt.update`` on the whole
    stack, bitwise, params and state."""
    gen = torch.Generator().manual_seed(5)
    R = 2
    opt = optim.make(name, 0.05)
    params = _random_tree(gen, R, dtype)
    state = spmd.stack_replicas(opt.init(T.map(lambda x: x[0], params)), R)
    p_f, s_f = T.map(torch.clone, params), T.map(torch.clone, state)
    for _ in range(3):
        grads = _random_tree(gen, R, dtype)
        p_f, s_f = opt.update(p_f, s_f, grads)
        for r in range(R):
            optim.update_in_place(opt, T.map(lambda x: x[r], params), T.map(lambda x: x[r], state),
                                  T.leaves(T.map(lambda x: x[r], grads)))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p_f)))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(state), T.leaves(s_f)))


def test_a_replica_step_reads_only_its_own_slice():
    """A shadow step whose batch differs only in replica 1 leaves replica 0's
    parameters, optimizer state and loss bitwise as they were; replica 1's
    move."""
    _, cfg = _cfgs("minicpm")
    params = _port(_jax_weights("minicpm"))
    opt = optim.adam(1e-3)
    step = spmd.make_train_step(cfg, opt, "shadow")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2 * 2, 32, seed=3)).long().reshape(2, 2, 32)
    other = toks.clone()
    other[1] = (other[1] + 7) % cfg.vocab_size
    out = []
    for t in (toks, other):
        stack = spmd.stack_replicas(params, 2)
        ost = spmd.stack_replicas(opt.init(params), 2)
        out.append(step(stack, ost, {"tokens": t}))
    (s0, o0, l0), (s1, o1, l1) = out
    assert torch.equal(l0[0], l1[0]) and not torch.equal(l0[1], l1[1])
    assert all(torch.equal(a[0], b[0]) for a, b in zip(T.leaves((s0, o0)), T.leaves((s1, o1))))
    assert not all(torch.equal(a[1], b[1]) for a, b in zip(T.leaves(s0), T.leaves(s1)))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_lm_launcher_loss_falls_on_the_cpu(algo, capsys):
    out = train.main(["lm", "--device", "cpu", "--iters", "20", "--algo", algo])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith(f"minicpm-2b x2 replicas [{algo}]: loss ")
    assert set(json.loads(printed[-1])) == {"loss_start", "loss_end"}
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    assert out["loss_end"] < out["loss_start"]


def test_lm_launcher_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["lm", "--iters", "1"])


# ---------------------------------------------------------------------------
# The ssm, MoE and hybrid families
# ---------------------------------------------------------------------------

# two SSD chunks of 32; reduced kimi-k2 is dropless with 384 times the
# expert slots its assignments need (the reference's reduced()), so its
# expert products grow with the square of the tokens: its sequences are
# half as long
FAMILY_S = {"kimi": 32}


def _close_adam_whole(got, want, lr):
    """``_close_adam`` with the stray count rounded up to a whole weight:
    the families' small leaves (a stacked conv weight holds 9,216) would
    otherwise allow no stray at all, and one was measured (a conv weight
    whose gradient, 1e-8, is of its rounding error's size)."""
    for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        stray = ~np.isclose(a, b, **TRAJ)
        assert stray.sum() <= np.ceil(ADAM_STRAY * a.size), (stray.sum(), a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_and_grads_follow_jax(name):
    """``loss_fn`` with unit remat (the CE plus the summed load-balance
    loss) and every gradient, mamba2's f32 ``A_log``, ``dt_bias`` and ``D``
    and the MoE router's among them."""
    jcfg, cfg = _cfgs(name)
    toks = _tokens(jcfg.vocab_size, 2, FAMILY_S.get(name, 64), seed=5)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, jcfg, b, remat=True)))(
        _jax_weights(name), {"tokens": jnp.asarray(toks)})
    params = T.map(lambda a: a.requires_grad_(), _port(_jax_weights(name)))
    loss = transformer.loss_fn(params, cfg, {"tokens": torch.tensor(toks).long()}, remat=True)
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TRAJ)
    _close(T.unflatten(params, list(grads)), j_grads)
    with torch.no_grad():
        _, aux = transformer.forward(params, cfg, torch.tensor(toks).long(), train=True)
    assert (float(aux) > 0) == (cfg.moe is not None)


@functools.lru_cache(maxsize=None)
def _jax_family_steps(name):
    """One syncdp step, then one shadow step of R=2 replicas and an EASGD
    sync, under Adam 1e-3, on the JAX package's token batches."""
    jcfg, _ = _cfgs(name)
    params = _jax_weights(name)
    opt = joptim.adam(1e-3)
    S = FAMILY_S.get(name, 64)
    toks = _tokens(jcfg.vocab_size, 2, S, seed=6)
    st = opt.init(params)
    p1, st1, loss1 = jax.jit(jspmd.make_train_step(jcfg, opt, "syncdp"))(
        params, st, {"tokens": jnp.asarray(toks)})
    stack, ost, sc, astate = _jax_setup(jcfg, params, opt, "easgd", 2)
    init = jax.tree.map(np.asarray, (stack, ost, astate))
    batch = {"tokens": jnp.asarray(toks.reshape(2, 1, S))}
    stack, ost, loss2 = jax.jit(jspmd.make_train_step(jcfg, opt, "shadow"))(stack, ost, batch)
    stack, astate = jax.jit(jspmd.make_sync_step(jcfg, sc))(stack, astate)
    return (toks, init, jax.tree.map(np.asarray, (p1, st1, loss1)),
            jax.tree.map(np.asarray, (stack, ost, astate, loss2)))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_and_sync_steps_follow_jax(name):
    """A syncdp step, and a shadow step of R=2 with the EASGD sync after it,
    from state carried in with ``interop.lm_train_state_from_numpy``:
    losses and optimizer states at TRAJ, weights as ``ADAM_STRAY`` says
    (``_close_adam_whole``)."""
    _, cfg = _cfgs(name)
    toks, init, (jp1, jst1, jl1), (jstack, jost, jps, jl2) = _jax_family_steps(name)
    opt = optim.adam(1e-3)
    params = _port(_jax_weights(name))
    p1, st1, l1 = spmd.make_train_step(cfg, opt, "syncdp")(
        params, opt.init(params), {"tokens": torch.tensor(toks).long()})
    np.testing.assert_allclose(float(l1), float(jl1), **TRAJ)
    _close_adam_whole(p1, jp1, 1e-3)
    _close(st1, jst1)
    stack, ost, ps = interop.lm_train_state_from_numpy(*init[:2], "easgd", init[2])
    stack, ost, l2 = spmd.make_train_step(cfg, opt, "shadow")(
        stack, ost, {"tokens": torch.tensor(toks.reshape(2, 1, -1)).long()})
    sync = spmd.make_sync_step(cfg, SyncConfig(algo="easgd", alpha=0.5).validate())
    stack, ps = sync(stack, ps)
    np.testing.assert_allclose(l2.numpy(), jl2, **TRAJ)
    _close_adam_whole(stack, jstack, 1e-3)
    _close(ost, jost)
    _close_adam_whole(ps, jps, 1e-3)


def test_mixed_dtype_state_keeps_every_leaf_dtype():
    """A bf16 jamba (f32 ``A_log``, ``dt_bias``, ``D`` and router beside bf16
    weights) carried in with its Adam state: a shadow step
    (``optim.update_in_place``) and an EASGD sync (``sync.lerp``) keep each
    leaf's dtype and finite values, and the carried state is bitwise the
    JAX package's."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs("jamba"))
    params = jspmd.init_params(jcfg, jax.random.PRNGKey(3))
    opt = joptim.adam(1e-3)
    stack, ost, _, astate = _jax_setup(jcfg, params, opt, "easgd", 2)
    init = jax.tree.map(np.asarray, (stack, ost, astate))
    t_stack, t_ost, t_ps = interop.lm_train_state_from_numpy(*init[:2], "easgd", init[2])
    dtypes = [x.dtype for x in T.leaves(t_stack)]
    assert {torch.float32, torch.bfloat16} <= set(dtypes)
    for got, want in zip(T.leaves((t_stack, t_ost, t_ps)), jax.tree.leaves(init)):
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 4, 32, seed=7)).long().reshape(2, 2, 32)
    t_stack, t_ost, loss = spmd.make_train_step(cfg, optim.adam(1e-3), "shadow")(
        t_stack, t_ost, {"tokens": toks})
    sync = spmd.make_sync_step(cfg, SyncConfig(algo="easgd", alpha=0.5).validate())
    t_stack, t_ps = sync(t_stack, t_ps)
    assert [x.dtype for x in T.leaves(t_stack)] == dtypes
    assert [x.dtype for x in T.leaves(t_ps)] == [x.dtype for x in T.leaves(t_stack)]
    assert all(bool(torch.isfinite(x.float()).all()) for x in T.leaves((t_stack, t_ost, t_ps)))
    assert torch.isfinite(loss).all()


@pytest.mark.parametrize("name", sorted(optim.REGISTRY))
def test_update_in_place_is_bitwise_on_a_mixed_dtype_tree(name):
    """``test_update_in_place_is_bitwise_the_functional_update`` on a tree
    whose leaves are f32 and bf16 side by side."""
    gen = torch.Generator().manual_seed(6)
    R = 2
    opt = optim.make(name, 0.05)

    def tree():
        return {"a": torch.randn((R, 6, 5), generator=gen).to(torch.bfloat16),
                "b": (torch.randn((R, 7), generator=gen),
                      {"c": torch.randn((R, 3, 2), generator=gen).to(torch.bfloat16)})}

    params = tree()
    state = spmd.stack_replicas(opt.init(T.map(lambda x: x[0], params)), R)
    p_f, s_f = T.map(torch.clone, params), T.map(torch.clone, state)
    for _ in range(3):
        grads = tree()
        p_f, s_f = opt.update(p_f, s_f, grads)
        for r in range(R):
            optim.update_in_place(opt, T.map(lambda x: x[r], params), T.map(lambda x: x[r], state),
                                  T.leaves(T.map(lambda x: x[r], grads)))
    assert [x.dtype for x in T.leaves(params)] == [torch.bfloat16, torch.float32, torch.bfloat16]
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p_f)))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(state), T.leaves(s_f)))


@pytest.mark.parametrize("arch,batch,seq", [("mamba2-780m", "2", "32"),
                                            ("jamba-1.5-large-398b", "2", "32"),
                                            ("phi3.5-moe-42b-a6.6b", "2", "32"),
                                            ("kimi-k2-1t-a32b", "1", "16"),
                                            ("llava-next-34b", "2", "32")])
def test_lm_launcher_trains_each_family_on_the_cpu(arch, batch, seq, capsys):
    """The ``lm`` launcher runs each family's reduced config, as the
    reference's ``run_lm`` does (kimi-k2 on fewer tokens: see
    ``FAMILY_S``; llava on tokens alone, its projector unread)."""
    out = train.main(["lm", "--device", "cpu", "--arch", arch, "--iters", "10",
                      "--batch-size", batch, "--seq-len", seq])
    assert capsys.readouterr().out.startswith(f"{arch} x2 replicas [easgd]: loss ")
    assert len(out["losses"]) == 10 and all(np.isfinite(out["losses"]))
    assert out["loss_end"] < out["loss_start"]
