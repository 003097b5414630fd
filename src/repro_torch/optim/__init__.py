"""Optimizers as (init, update) pairs over parameter trees, the twin of
``repro/optim/__init__.py``: ``state = opt.init(params); params, state =
opt.update(params, state, grads)``. Updates are functional (new tensors), and
elementwise, so a tree with a leading replica dim updates every replica at
once. ``update_in_place`` applies an optimizer's ``update`` one leaf at a
time and writes the result back, for trees too large to hold twice."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

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


def update_in_place(opt: Optimizer, params: Tree, state: Tree, grads: List) -> None:
    """``opt.update(params, state, grads)`` written back into ``params`` and
    ``state``, one leaf at a time, so only one leaf's new values are alive
    at once; bitwise the functional update (the same calls, a leaf each).
    ``params`` and ``state`` may be views into larger stacks (a replica's
    slice). ``grads`` is the list of the leaves' gradients in ``T.leaves``
    order; each entry is dropped once its leaf is written. A subtree of
    ``state`` shaped as ``params`` (moments, accumulators) is taken leaf by
    leaf; its other leaves (Adam's step count) are shared by every leaf and
    written after the last one has read them."""
    shape = _shape(params)
    leaves = T.leaves(params)
    for i, p in enumerate(leaves):
        new_p, new_st = opt.update(p, _pick(state, shape, i), grads[i])
        grads[i] = None
        p.copy_(new_p)
        _write(state, new_st, shape, i, last=i == len(leaves) - 1)


def _shape(tree: Tree) -> Tree:
    return T.map(lambda _: None, tree)


def _pick(state: Tree, shape: Tree, i: int) -> Tree:
    """``state`` for leaf ``i``: params-shaped subtrees give their ``i``-th leaf."""
    if _shape(state) == shape:
        return T.leaves(state)[i]
    if isinstance(state, dict):
        return {k: _pick(v, shape, i) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_pick(v, shape, i) for v in state)
    return state


def _write(state: Tree, new: Tree, shape: Tree, i: int, last: bool) -> None:
    """``_pick``'s inverse: leaf ``i`` of each params-shaped subtree, and
    the shared leaves once ``last``."""
    if _shape(state) == shape:
        T.leaves(state)[i].copy_(new)
    elif isinstance(state, dict):
        for k in state:
            _write(state[k], new[k], shape, i, last)
    elif isinstance(state, (tuple, list)):
        for s, n in zip(state, new):
            _write(s, n, shape, i, last)
    elif last:
        state.copy_(new)


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay schedule (MiniCPM [arXiv:2404.06395]): linear
    warmup to ``peak_lr``, flat for ``stable`` steps, then linear decay to
    a tenth of it over ``decay`` steps. ``lr_at`` takes a step tensor."""

    def lr_at(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        return torch.where(step < warmup + stable, warm,
                           peak_lr * (1.0 - frac) + 0.1 * peak_lr * frac)

    return lr_at


REGISTRY = {"sgd": sgd, "momentum": momentum, "adagrad": adagrad, "rmsprop": rmsprop, "adam": adam}


def make(name: str, lr: float, **kw) -> Optimizer:
    return REGISTRY[name](lr, **kw)
