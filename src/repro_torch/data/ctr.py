"""Synthetic CTR data with ground-truth logistic structure, the twin of
``repro/data/ctr.py``: clicks come from a hidden teacher (true per-row latent
vectors, dense weights, a tanh output layer) and batch ``i`` is a pure
function of (seed, i), so the stream is one-pass by construction.

The random draws come from CPU ``torch.Generator``s, so a seed gives the same
stream on every device; the teacher's arithmetic runs on the teacher's
device. ``torch`` cannot reproduce ``jax.random``'s bits, so the two packages'
streams differ; parity tests feed the port the JAX package's batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class CTRTeacher:
    """Hidden ground-truth model; fields are tensors on one device."""

    true_rows: torch.Tensor  # (total_rows, k) true latent per categorical row
    w_dense: torch.Tensor  # (n_dense, k)
    w_out: torch.Tensor  # (k,)
    bias: torch.Tensor  # ()


def _generator(*key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator().manual_seed(seed)


def make_teacher(cfg, seed: int = 0, k: int = 8, device=None) -> CTRTeacher:
    gen = _generator(seed)
    total = int(sum(cfg.table_sizes))
    true_rows = torch.randn((total, k), generator=gen) * 0.8
    w_dense = torch.randn((cfg.n_dense_features, k), generator=gen) * 0.5
    w_out = torch.randn((k,), generator=gen)
    bias = torch.tensor(-1.5)  # base CTR well below 50%, like real ads data
    return CTRTeacher(*(t.to(device) for t in (true_rows, w_dense, w_out, bias)))


def _offsets(cfg) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([[0], np.cumsum(cfg.table_sizes)[:-1]]), dtype=torch.int32)


def _draws(cfg, seed: int, batch_idx: int, batch_size: int):
    """Batch ``batch_idx``'s random draws on the CPU, in the order the stream
    makes them: (dense, idx, u_label)."""
    gen = _generator(seed, batch_idx)
    F, m = cfg.n_sparse_features, cfg.multi_hot
    dense = torch.randn((batch_size, cfg.n_dense_features), generator=gen)
    u = torch.rand((batch_size, F, m), generator=gen)
    u_label = torch.rand((batch_size,), generator=gen)
    sizes = torch.as_tensor(cfg.table_sizes, dtype=torch.int32)[None, :, None]
    # Zipf-ish skew: square a uniform to concentrate on low ids (hot rows).
    idx = torch.minimum((u * u * sizes).to(torch.int32), sizes - 1)
    return dense, idx, u_label


def sparse_ids(cfg, seed: int, batch_idx: int, batch_size: int) -> np.ndarray:
    """Batch ``batch_idx``'s ``sparse`` ids alone, on the host, without the
    teacher or the device: the peek of the cache's lookahead prefetch."""
    return _draws(cfg, seed, batch_idx, batch_size)[1].numpy()


def gen_batch(cfg, teacher: CTRTeacher, seed: int, batch_idx: int,
              batch_size: int) -> Dict[str, torch.Tensor]:
    """Pure function of (seed, batch_idx): the one-pass stream, on the
    teacher's device. sparse: (B, F, m) int32 per-feature row ids."""
    F, m = cfg.n_sparse_features, cfg.multi_hot
    dense, idx, u_label = _draws(cfg, seed, batch_idx, batch_size)

    dev = teacher.true_rows.device
    dense, idx, u_label = dense.to(dev), idx.to(dev), u_label.to(dev)
    rows = (idx + _offsets(cfg).to(dev)[None, :, None]).long()
    latent = teacher.true_rows[rows].sum(dim=(1, 2))  # (B, k)
    latent = latent / (F * m) + dense @ teacher.w_dense
    score = torch.tanh(latent) @ teacher.w_out + teacher.bias
    labels = (u_label < torch.sigmoid(score)).float()
    return {"dense": dense, "sparse": idx, "labels": labels}
