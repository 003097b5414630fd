"""Packed embedding tables with Hogwild-style sparse Adagrad updates, the twin
of ``repro/embeddings/table.py``.

All categorical tables are packed into ONE (total_rows, dim) tensor with the
Adagrad accumulators beside it (paper §3.2). Forward (``lookup``) goes through
the embedding-bag kernel and the backward (``sparse_adagrad_update_fused``)
through the sparse-Adagrad kernel, which updates the tables in place.
``lookup_ref`` / ``sparse_adagrad_update`` are the plain oracles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TableSpec:
    sizes: Tuple[int, ...]
    dim: int
    multi_hot: int

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(sum(self.sizes))


def spec_from_config(cfg) -> TableSpec:
    return TableSpec(tuple(cfg.table_sizes), cfg.embedding_dim, cfg.multi_hot)


def init_tables(spec: TableSpec, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Normal(0, 1) * dim**-0.5 rows drawn from ``gen`` (a CPU generator), zero
    accumulators."""
    table = torch.randn((spec.total_rows, spec.dim), generator=gen) * spec.dim ** -0.5
    return {"table": table.to(device=device, dtype=dtype),
            "acc": torch.zeros((spec.total_rows, spec.dim), dtype=torch.float32, device=device)}


def global_row_ids(spec: TableSpec, idx: torch.Tensor) -> torch.Tensor:
    """idx: (B, F, m) per-feature local row ids -> global packed row ids."""
    offsets = torch.as_tensor(spec.offsets, device=idx.device)
    return idx + offsets[None, :, None]


def lookup_ref(state: Params, spec: TableSpec, idx: torch.Tensor) -> torch.Tensor:
    """Oracle for ``lookup``: dense gather + sum-pool."""
    return state["table"][global_row_ids(spec, idx).long()].sum(2)


def lookup(state: Params, spec: TableSpec, idx: torch.Tensor) -> torch.Tensor:
    """Sum-pooled lookup. idx: (B, F, m) -> (B, F, dim). One kernel launch."""
    return embedding_bag_op(state["table"], global_row_ids(spec, idx))


def sparse_adagrad_update(state: Params, spec: TableSpec, idx: torch.Tensor,
                          g_pooled: torch.Tensor, lr: float, eps: float = 1e-8) -> Params:
    """Oracle: row-sparse Adagrad, out of place. g_pooled: (B, F, d); with sum
    pooling each of the multi-hot rows receives the pooled gradient. Every
    occurrence's g^2 lands before any row step."""
    B, F, m = idx.shape
    rows = global_row_ids(spec, idx).reshape(-1).long()
    g = g_pooled[:, :, None, :].expand(B, F, m, g_pooled.shape[-1])
    g = g.reshape(-1, g_pooled.shape[-1]).float()
    acc = state["acc"].index_add(0, rows, g * g)
    scale = lr * torch.rsqrt(acc[rows] + eps)
    table = state["table"].index_add(0, rows, (-scale * g).to(state["table"].dtype))
    return {"table": table, "acc": acc}


def sparse_adagrad_update_fused(state: Params, spec: TableSpec, idx: torch.Tensor,
                                g_pooled: torch.Tensor, lr: float,
                                eps: float = 1e-8) -> Params:
    """``sparse_adagrad_update`` through the fused kernel, IN PLACE on
    ``state``'s tensors (the TPU kernel aliases them too); returns ``state``."""
    bags = global_row_ids(spec, idx).reshape(-1, idx.shape[-1])  # (B*F, m)
    g = g_pooled.reshape(-1, g_pooled.shape[-1])
    sparse_adagrad_op(state["table"], state["acc"], bags, g, lr=lr, eps=eps)
    return state
