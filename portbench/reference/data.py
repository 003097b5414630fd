"""Inputs and weights, made from ``--seed`` on the device in a few large
calls; the same seed gives the same inputs and the same weights, which both
the program and the reference are handed.

The distributions are frozen copies of the program's synthetic streams:
the CTR batches of ``data/ctr.py`` (ids ``floor(u^2 * rows)`` per table,
labels drawn from a hidden teacher) and the order-1 Markov token stream of
``data/tokens.py``, here drawn by ``torch.Generator``s on the card.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F_


def key(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed and a path of ints (any
    size; a negative seed is taken modulo 2**64)."""
    words = [int(seed) % 2**64, *(int(p) for p in parts)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def generator(device, seed: int, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, *parts))


# -- the CTR stream ------------------------------------------------------------

def offsets(cfg: dict) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg["table_sizes"])[:-1]]).astype(np.int32)


TEACHER_ROWS = 1 << 16  # latent vectors of the teacher, shared by hashing the row ids
HASH = 2654435761  # Knuth's multiplicative hash


def make_teacher(cfg: dict, seed: int, device, k: int = 8) -> Dict[str, torch.Tensor]:
    """The hidden ground truth (``data/ctr.py::make_teacher``): a latent
    vector a categorical row, dense weights and a tanh output layer. The
    rows share ``TEACHER_ROWS`` latent vectors by a hash of their id, so
    the teacher's lookups stay in the card's L2 cache and the batch draw
    takes little of an iteration; the ids and their skew are the stream's."""
    g = generator(device, seed, 1)
    return {"true_rows": torch.randn((TEACHER_ROWS, k), generator=g, device=device) * 0.8,
            "w_dense": torch.randn((cfg["n_dense_features"], k), generator=g, device=device) * 0.5,
            "w_out": torch.randn((k,), generator=g, device=device),
            "bias": torch.tensor(-1.5, device=device)}


def ctr_batch(cfg: dict, teacher: Dict[str, torch.Tensor], seed: int, it: int,
              n: int) -> Dict[str, torch.Tensor]:
    """Batch ``it`` of the stream, ``n`` examples on the teacher's device:
    dense (n, 13) f32, sparse (n, F, m) int32 per-table row ids, labels (n,)."""
    dev = teacher["true_rows"].device
    F, m = cfg["n_sparse_features"], cfg["multi_hot"]
    g = generator(dev, seed, 2, it)
    dense = torch.randn((n, cfg["n_dense_features"]), generator=g, device=dev)
    u = torch.rand((n, F, m), generator=g, device=dev)
    u_label = torch.rand((n,), generator=g, device=dev)
    sizes = torch.as_tensor(cfg["table_sizes"], dtype=torch.int32, device=dev)[None, :, None]
    # Zipf-ish skew: a squared uniform concentrates on low ids (hot rows)
    idx = torch.minimum((u * u * sizes).to(torch.int32), sizes - 1)
    rows = (idx + torch.as_tensor(offsets(cfg), device=dev)[None, :, None]).long()
    bucket = (rows * HASH) % TEACHER_ROWS
    latent = F_.embedding_bag(bucket.reshape(n, F * m), teacher["true_rows"], mode="mean")
    latent = latent + dense @ teacher["w_dense"]
    score = torch.tanh(latent) @ teacher["w_out"] + teacher["bias"]
    labels = (u_label < torch.sigmoid(score)).float()
    return {"dense": dense, "sparse": idx, "labels": labels}


def dlrm_dense(cfg: dict, seed: int, device) -> dict:
    """The MLPs' weights, Normal(0, 1) * d_in**-0.5, biases zero, in the
    program's tree layout: {"bottom": ({"w", "b"}, ...), "top": (...)}."""
    g = generator(device, seed, 3)
    d = cfg["embedding_dim"]
    n_vec = cfg["n_sparse_features"] + 1

    def mlp(dims):
        return tuple({"w": torch.randn((a, b), generator=g, device=device) * a ** -0.5,
                      "b": torch.zeros((b,), device=device)}
                     for a, b in zip(dims[:-1], dims[1:]))

    return {"bottom": mlp([cfg["n_dense_features"], *cfg["bottom_mlp"]]),
            "top": mlp([d + n_vec * (n_vec - 1) // 2, *cfg["top_mlp"]])}


def dlrm_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """The packed tables, (rows, d) Normal(0, 1) * d**-0.5, in one call and
    scaled in place (no second copy at the peak)."""
    g = generator(device, seed, 4)
    d = cfg["embedding_dim"]
    table = torch.randn((int(sum(cfg["table_sizes"])), d), generator=g, device=device)
    return table.mul_(d ** -0.5)


# -- the LM ----------------------------------------------------------------------

def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def lm_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight in ``dtype``, drawn on the device a kind at a time for
    all layers at once: Normal(0, 1) * d_in**-0.5 for the projections, 0.02
    for the embedding table (padded to a multiple of 256 rows), ones for
    the norms. Flat names; (L, ...) for the layers' leaves."""
    g = generator(device, seed, 5)
    L, d, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    hq, hkv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(scale)

    return {"wq": draw((L, d, hq), d ** -0.5), "wk": draw((L, d, hkv), d ** -0.5),
            "wv": draw((L, d, hkv), d ** -0.5), "wo": draw((L, hq, d), hq ** -0.5),
            "w_gate": draw((L, d, ff), d ** -0.5), "w_up": draw((L, d, ff), d ** -0.5),
            "w_down": draw((L, ff, d), ff ** -0.5),
            "norm1": torch.ones((L, d), device=device, dtype=dtype),
            "norm2": torch.ones((L, d), device=device, dtype=dtype),
            "table": draw((padded_vocab(cfg), d), 0.02),
            "final_norm": torch.ones((d,), device=device, dtype=dtype)}


def markov_tokens(seed: int, n_steps: int, rows: int, seq: int, vocab: int,
                  device, concentration: float = 0.3) -> List[torch.Tensor]:
    """``n_steps`` batches of ``rows`` chains of ``seq`` tokens over the first
    ``vocab`` ids (``data/tokens.py``'s chain: a softmax of Normal / 0.3
    transition, each chain from a uniform token, sampled by inverse CDF),
    all drawn at once; a list of (rows, seq) int64."""
    g = generator(device, seed, 6)
    cdf = torch.softmax(torch.randn((vocab, vocab), generator=g, device=device)
                        / concentration, dim=-1).cumsum(dim=-1)
    n = n_steps * rows
    tok = torch.randint(0, vocab, (n,), generator=g, device=device)
    u = torch.rand((seq - 1, n, 1), generator=g, device=device)
    out = torch.empty((n, seq), dtype=torch.int64, device=device)
    out[:, 0] = tok
    for s in range(1, seq):
        tok = torch.searchsorted(cdf[tok], u[s - 1], right=True)[:, 0].clamp_(max=vocab - 1)
        out[:, s] = tok
    return list(out.reshape(n_steps, rows, seq))
