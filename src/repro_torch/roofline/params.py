"""Parameter counting (total and MoE-active) from ArchConfig, without allocation.

``param_count`` walks ``spmd.init_params`` under ``FakeTensorMode``: every
draw, cast and stack is carried out on shapes alone, with no storage
(a CPU generator cannot draw onto ``meta`` tensors here, since the draws
happen on the generator's device), so kimi-k2's 1.04 T parameters are
counted in seconds. The reference uses ``jax.eval_shape`` to the same end.
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig


@functools.lru_cache(maxsize=None)  # an int per (frozen, hashable) config
def param_count(cfg: ArchConfig) -> int:
    from repro_torch.core import spmd

    with FakeTensorMode():
        params = spmd.init_params(cfg, torch.Generator(), device="cpu")
        return sum(t.numel() for t in T.leaves(params))


def _expert_params_per_moe_layer(cfg: ArchConfig) -> int:
    m = cfg.moe
    return m.n_experts * cfg.d_model * m.d_ff_expert * 3  # gate, up, down


def active_param_count(cfg: ArchConfig) -> int:
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(1 for i in range(len(cfg.layer_pattern)) if cfg.is_moe_layer(i)) \
        * (cfg.n_layers // len(cfg.layer_pattern))
    expert_total = n_moe_layers * _expert_params_per_moe_layer(cfg)
    active_frac = m.top_k / m.n_experts
    return int(total - expert_total * (1.0 - active_frac))
