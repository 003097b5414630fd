"""The port's LM data and loss pieces against the JAX package's: the token
stream (``data/tokens.py``), the prefetching loader (``data/loader.py``),
``chunked_softmax_ce`` and ``cross_entropy`` (``models/layers.py``) and
``wsd_schedule`` (``optim``). Inputs are numpy from a seed; the tolerance
is the kernel one, ``rtol=1e-5, atol=1e-6`` (``tests/test_flatspace.py:23``),
unless a case's docstring says otherwise.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data import loader, tokens  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------

def test_transition_rows_are_distributions():
    trans = tokens.make_transition(64, seed=3)
    assert trans.shape == (64, 64) and trans.dtype == torch.float32
    assert (trans >= 0).all()
    torch.testing.assert_close(trans.sum(-1), torch.ones(64), rtol=0, atol=1e-5)
    assert torch.equal(trans, tokens.make_transition(64, seed=3))
    assert not torch.equal(trans, tokens.make_transition(64, seed=4))


@pytest.mark.parametrize("vocab,batch,seq", [(64, 4, 33), (512, 8, 128)])
def test_batches_are_pure_in_seed_and_index(vocab, batch, seq):
    trans = tokens.make_transition(vocab, seed=0)
    a = tokens.gen_batch(trans, 0, 5, batch, seq)["tokens"]
    assert a.shape == (batch, seq) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < vocab
    assert torch.equal(a, tokens.gen_batch(trans, 0, 5, batch, seq)["tokens"])
    assert not torch.equal(a, tokens.gen_batch(trans, 0, 6, batch, seq)["tokens"])
    assert not torch.equal(a, tokens.gen_batch(trans, 1, 5, batch, seq)["tokens"])
    got = [b["tokens"] for b in tokens.stream(trans, 0, batch, seq, 3)]
    assert all(torch.equal(g, tokens.gen_batch(trans, 0, i, batch, seq)["tokens"])
               for i, g in enumerate(got))


def test_the_chain_follows_its_transition():
    """The bigram frequencies of a long stream follow the transition: every
    pair the chain draws has positive probability, and each row's
    empirical distribution is within sampling error of its row."""
    vocab = 8
    trans = tokens.make_transition(vocab, seed=1, concentration=1.0)
    toks = tokens.gen_batch(trans, 0, 0, 64, 1025)["tokens"]
    pairs = torch.zeros((vocab, vocab))
    pairs.index_put_((toks[:, :-1].reshape(-1), toks[:, 1:].reshape(-1)),
                     torch.ones(64 * 1024), accumulate=True)
    freq = pairs / pairs.sum(-1, keepdim=True)
    # 65,536 draws over 8 rows: ~8,000 a row, sampling error ~0.005 a cell
    assert (freq - trans).abs().max() < 0.03


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch,delay_s", [(1, 0.0), (4, 0.0), (2, 0.002)])
def test_prefetch_loader_order_and_end(prefetch, delay_s):
    """Batches come in order, the stream ends after the last (the ``None``
    sentinel), the filling thread is a daemon and finishes: as the JAX
    package's loader."""
    make = lambda i: {"i": i}  # noqa: E731
    ld = loader.PrefetchLoader(make, 9, prefetch=prefetch, delay_s=delay_s)
    assert ld._thread.daemon
    got = [b["i"] for b in ld]
    assert got == list(range(9))
    assert got == [b["i"] for b in jloader.PrefetchLoader(make, 9, prefetch=prefetch,
                                                          delay_s=delay_s)]
    ld._thread.join(timeout=5.0)
    assert not ld._thread.is_alive()


def test_prefetch_loader_fills_ahead_of_the_consumer():
    """The filler runs ahead of a consumer that holds the first batch, by
    the queue's ``prefetch`` batches and the one it waits to put, no more."""
    made = []
    ready = threading.Event()

    def make(i):
        made.append(i)
        if len(made) == 5:
            ready.set()
        return i

    ld = loader.PrefetchLoader(make, 10, prefetch=3)
    it = iter(ld)
    assert next(it) == 0
    assert ready.wait(timeout=5.0)  # 0 taken, 1-3 queued, 4 made
    time.sleep(0.05)
    assert made == [0, 1, 2, 3, 4]  # 4 waits on the full queue
    assert list(it) == list(range(1, 10))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,vocab_limit", [(64, 512, 256), (100, 32, 250), (70, 16, 200),
                                                 (33, 33, 256)])
def test_chunked_softmax_ce_and_its_gradients_follow_jax(S, chunk, vocab_limit):
    """Values and gradients (w.r.t. the hidden states and the head) of the
    chunked CE: one chunk, padded chunks, padded vocabulary columns, and
    weights with zeros (the last position, as ``loss_fn`` sets them)."""
    rng = np.random.default_rng(S)
    B, d, V = 2, 16, 256
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab_limit, (B, S)).astype(np.int32)
    weights = np.ones((B, S), np.float32)
    weights[:, -1] = 0.0
    weights[0, :3] = 0.0

    def jfn(x_, w_):
        return jlayers.chunked_softmax_ce(x_, w_, jnp.asarray(labels), jnp.asarray(weights),
                                          vocab_limit, chunk=chunk)

    j_loss, (j_gx, j_gw) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    loss = layers.chunked_softmax_ce(tx, tw, torch.tensor(labels), torch.tensor(weights),
                                     vocab_limit, chunk=chunk)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), **TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(j_gw), **TOL)
    if vocab_limit < V:  # padded columns take no gradient
        assert torch.equal(gw[:, vocab_limit:], torch.zeros_like(gw[:, vocab_limit:]))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_cross_entropy_follows_jax(dtype):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 5, 40)) * 3).astype(dtype)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = float(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(layers.cross_entropy(torch.tensor(logits), torch.tensor(labels)))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# wsd_schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,stable,decay", [(10, 20, 30), (0, 5, 10), (4, 0, 1)])
def test_wsd_schedule_follows_jax_at_every_phase_boundary(warmup, stable, decay):
    """Each phase's first and last step and their neighbours: warmup's
    start, the peak, the end of the stable phase, the decay's middle and
    end, and past it (a tenth of the peak)."""
    peak = 3e-3
    steps = sorted({max(s, 0) for b in (0, warmup, warmup + stable, warmup + stable + decay // 2,
                                        warmup + stable + decay)
                    for s in (b - 1, b, b + 1)} | {warmup + stable + decay + 50})
    got = optim.wsd_schedule(peak, warmup, stable, decay)(torch.tensor(steps, dtype=torch.int32))
    want = joptim.wsd_schedule(peak, warmup, stable, decay)(jnp.asarray(steps, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got[-1].item() == pytest.approx(0.1 * peak)
    assert got.max().item() == pytest.approx(peak)
