"""Operations and bytes: the yardstick's own arithmetic, from shapes and
from the batch's own ids, never from the program.

Kernel bytes count each input byte read once and each output byte written
once (frozen from ``chip_smoke.py``'s K1 and K2 bounds); model FLOPs count the
model's products once, with no recompute.
"""
from __future__ import annotations

from typing import Dict, Sequence


def k1_work(n_bags: int, n_items: int, n_unique: int, d: int) -> Dict[str, float]:
    """Embedding bag: each distinct row read once, the ids once, the pooled
    bags written once; (m - 1) adds a bag per lane."""
    m = n_items // max(n_bags, 1)
    return {"bytes": (n_unique * d + n_items + n_bags * d) * 4.0,
            "flops": float(n_bags * (m - 1) * d)}


def k2_work(n_bags: int, n_items: int, n_unique: int, d: int) -> Dict[str, float]:
    """Sparse Adagrad: the bag gradients read once, the ids and their sorted
    copy once, each distinct row's table and accumulator read and written
    once; four operations an occurrence a lane."""
    return {"bytes": (n_bags * d + 2 * n_items + n_unique * 4 * d) * 4.0,
            "flops": float(n_items * 4 * d)}


def mlp_macs(dims: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def dlrm_flops_per_example(cfg: dict) -> float:
    """Model FLOPs of one example, forward and backward (3x the forward):
    the bottom and top MLPs' products and the interaction's upper triangle
    of dot products. Biases, activations and the lookup's adds are left out."""
    d = cfg["embedding_dim"]
    n_vec = cfg["n_sparse_features"] + 1
    pairs = n_vec * (n_vec - 1) // 2
    bottom = [cfg["n_dense_features"], *cfg["bottom_mlp"]]
    top = [d + pairs, *cfg["top_mlp"]]
    fwd = 2 * (mlp_macs(bottom) + mlp_macs(top) + pairs * d)
    return 3.0 * fwd


def lm_params_for_flops(cfg: dict) -> int:
    """N of 6·N·tokens: every layer's projections and the head (the tied
    table counted once, at the real vocabulary); norms left out."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    attn = d * cfg["n_heads"] * hd * 2 + d * cfg["n_kv_heads"] * hd * 2
    ffn = 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn) + cfg["vocab_size"] * d


def lm_flops_per_step(cfg: dict, tokens: int, seq: int) -> float:
    """Model FLOPs of a training step over ``tokens`` tokens of sequences of
    ``seq``: 6·N per token plus PaLM's attention term 12·L·H·Q·T per token
    (arXiv:2204.02311, App. B), counted once, with no recompute."""
    n = lm_params_for_flops(cfg)
    attn = 12 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * seq
    return float(tokens) * (6 * n + attn)
