"""Synthetic LM token stream (an order-1 Markov chain), the twin of
``repro/data/tokens.py``: a Markov teacher gives the LM something learnable
(the loss can fall below the uniform entropy), unlike i.i.d. tokens.

The random draws come from CPU ``torch.Generator``s keyed by ``seed`` and
(``seed``, ``batch_idx``), as ``data/ctr.py``'s do, and the chain is sampled
on the CPU by inverse CDF, so a seed gives the same stream on every device;
the caller moves the tokens. ``torch`` cannot reproduce ``jax.random``'s
bits, so the two packages' streams differ; parity tests feed the port the
JAX package's batches.

A transition is (V, V) f32, so its size bounds V: 4 V^2 bytes (64 MiB at
4,096). Its ids are valid for any model whose vocabulary holds V.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.data.ctr import _generator


def make_transition(vocab: int, seed: int = 0, concentration: float = 0.3) -> torch.Tensor:
    """(vocab, vocab) row-stochastic matrix on the CPU: softmax of
    Normal(0, 1) / ``concentration`` logits."""
    logits = torch.randn((vocab, vocab), generator=_generator(seed)) / concentration
    return torch.softmax(logits, dim=-1)


def gen_batch(trans: torch.Tensor, seed: int, batch_idx: int, batch: int,
              seq: int) -> Dict[str, torch.Tensor]:
    """Pure function of (seed, batch_idx): ``batch`` chains of ``seq``
    tokens, each starting from a uniform token. {"tokens": (batch, seq)
    int64} on the CPU."""
    vocab = trans.shape[0]
    gen = _generator(seed, batch_idx)
    t0 = torch.randint(0, vocab, (batch,), generator=gen)
    u = torch.rand((seq - 1, batch, 1), generator=gen)
    cdf = trans.cumsum(dim=-1)
    tokens = torch.empty((batch, seq), dtype=torch.int64)
    tokens[:, 0] = tok = t0
    for s in range(1, seq):
        # the first column whose cumulative probability passes u (rounding
        # may leave the row's last sum below u: clamp to the last id)
        tok = torch.searchsorted(cdf[tok], u[s - 1], right=True)[:, 0].clamp_(max=vocab - 1)
        tokens[:, s] = tok
    return {"tokens": tokens}


def stream(trans: torch.Tensor, seed: int, batch: int, seq: int,
           n_batches: int) -> Iterator[Dict[str, torch.Tensor]]:
    for i in range(n_batches):
        yield gen_batch(trans, seed, i, batch, seq)
