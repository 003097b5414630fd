"""DLRM (the paper's model): bottom MLP -> dot interaction -> top MLP
[arXiv:1906.00091], the twin of ``repro/models/dlrm.py``.

Dense weights are a plain tree of tensors, ``{"bottom": (layer, ...), "top":
(layer, ...)}`` with ``{"w", "b"}`` layers, as in the JAX package, so the
flat packing (core/flatspace.py) matches it leaf for leaf. Every function
here also takes weights with extra leading dims (one set of weights per
trainer and per Hogwild thread): the matmuls batch over them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as T
from repro_torch.models.layers import dense_init

Params = dict


def init_dense(cfg, gen: torch.Generator, dtype=torch.float32, device=None) -> Params:
    """MLP weights (the ShadowSync-replicated part)."""
    d = cfg.embedding_dim
    n_vec = cfg.n_sparse_features + 1
    top_in = d + n_vec * (n_vec - 1) // 2

    def mlp(dims):
        return tuple(
            {"w": dense_init(gen, dims[i], dims[i + 1], dtype, device=device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1))

    return {"bottom": mlp((cfg.n_dense_features,) + tuple(cfg.bottom_mlp)),
            "top": mlp((top_in,) + tuple(cfg.top_mlp))}


def _mlp(layers, x: torch.Tensor, final_linear: bool) -> torch.Tensor:
    n = len(layers)
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"].unsqueeze(-2)
        if not (final_linear and i == n - 1):
            x = torch.relu(x)
    return x


def interact(bottom_out: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Pairwise dot interaction. bottom_out: (..., B, d); pooled: (..., B, F, d).
    Plain torch, as the JAX package leaves it to XLA."""
    z = torch.cat([bottom_out.unsqueeze(-2), pooled], dim=-2)  # (..., B, F+1, d)
    dots = z @ z.transpose(-1, -2)
    n = z.shape[-2]
    iu, ju = torch.triu_indices(n, n, offset=1, device=z.device)
    return torch.cat([bottom_out, dots[..., iu, ju]], dim=-1)


def forward(w: Params, dense_x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Returns logits (..., B)."""
    bot = _mlp(w["bottom"], dense_x, final_linear=False)
    feat = interact(bot, pooled.to(bot.dtype))
    return _mlp(w["top"], feat, final_linear=True)[..., 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, mean over the last (batch) dim, in
    the reference's stable form."""
    logits = logits.float()
    per = torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return per.mean(-1)


def dense_loss_and_grads(w: Params, dense_x: torch.Tensor, pooled: torch.Tensor,
                         labels: torch.Tensor) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Returns (loss, grad_w, grad_pooled); grad_pooled is shipped to the
    embedding tables for the sparse Hogwild row update.

    Leading dims of the inputs beyond the batch are independent copies (one
    per trainer and thread): ``loss`` keeps them, and each copy's gradients
    are those of its own mean loss, as ``jax.vmap`` of the reference gives."""
    w = T.map(lambda x: x.detach().requires_grad_(True), w)
    pooled = pooled.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = bce_loss(forward(w, dense_x, pooled), labels)
        grads = torch.autograd.grad(loss.sum(), T.leaves(w) + [pooled])
    return loss.detach(), T.unflatten(w, list(grads[:-1])), grads[-1]
