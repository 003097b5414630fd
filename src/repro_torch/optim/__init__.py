"""Optimizers as (init, update) pairs over parameter trees, the twin of
``repro/optim/__init__.py``: ``state = opt.init(params); params, state =
opt.update(params, state, grads)``. Updates are functional (new tensors), and
elementwise, so a tree with a leading replica dim updates every replica at
once."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as T

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str = "opt"


def _zeros(params: Tree) -> Tree:
    return T.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd(lr: float) -> Optimizer:
    def update(params, state, grads):
        return T.map(lambda p, g: p - (lr * g).to(p.dtype), params, grads), state

    return Optimizer(lambda params: (), update, "sgd")


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def update(params, state, grads):
        new_v = T.map(lambda v, g: beta * v + g.float(), state, grads)
        step = T.map(lambda v, g: beta * v + g.float(), new_v, grads) if nesterov else new_v
        return T.map(lambda p, s: p - (lr * s).to(p.dtype), params, step), new_v

    return Optimizer(_zeros, update, "momentum")


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    def update(params, state, grads):
        new_acc = T.map(lambda a, g: a + torch.square(g.float()), state, grads)
        new_p = T.map(lambda p, a, g: p - (lr * g.float() * torch.rsqrt(a + eps)).to(p.dtype),
                      params, new_acc, grads)
        return new_p, new_acc

    return Optimizer(_zeros, update, "adagrad")


def rmsprop(lr: float, decay: float = 0.99, eps: float = 1e-8) -> Optimizer:
    def update(params, state, grads):
        new_s = T.map(lambda s, g: decay * s + (1 - decay) * torch.square(g.float()),
                      state, grads)
        new_p = T.map(lambda p, s, g: p - (lr * g.float() * torch.rsqrt(s + eps)).to(p.dtype),
                      params, new_s, grads)
        return new_p, new_s

    return Optimizer(_zeros, update, "rmsprop")


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaf = T.leaves(params)[0]
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(params, state, grads):
        t = state["t"] + 1
        m = T.map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = T.map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()), state["v"], grads)
        c1 = 1 - b1 ** t.float()
        c2 = 1 - b2 ** t.float()

        def step(p, m_, v_):
            # t carries the leading replica dims of a stacked state
            lead = (1,) * (m_.dim() - c1.dim())
            upd = (m_ / c1.reshape(c1.shape + lead)) * torch.rsqrt(
                v_ / c2.reshape(c2.shape + lead) + eps * eps)  # ~adamw form
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return p - (lr * upd).to(p.dtype)

        return T.map(step, params, m, v), {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam")


REGISTRY = {"sgd": sgd, "momentum": momentum, "adagrad": adagrad, "rmsprop": rmsprop, "adam": adam}


def make(name: str, lr: float, **kw) -> Optimizer:
    return REGISTRY[name](lr, **kw)
