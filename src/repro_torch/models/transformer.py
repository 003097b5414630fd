"""Decoder stack for the dense family: full-sequence ``forward``, ``prefill``
(forward + cache build) and ``decode_step`` (one token against the cache).

The reference's stacked layout is kept: layers are grouped by the repeating
``layer_pattern`` unit and each unit position's leaves carry a leading
``repeats`` dimension. A Python loop over the repeats takes the place of
``lax.scan``, so weights carried across from the JAX package
(``interop.lm_params_from_numpy``) are used as they are.

Only the dense family is ported. The mamba2 mixer, MoE layers, the vision
projector and the ``parallel_block`` variant raise ``NotImplementedError``
naming their ROADMAP queue-1 item by its subject, as does any family other
than dense.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    Params,
    attention_apply,
    attention_decode,
    attention_init,
    dense_init,
    dtype_of,
    embed_init,
    embed_lookup,
    init_attention_cache,
    rmsnorm,
    rmsnorm_init,
    rope_tables,
    swiglu,
    swiglu_init,
)


def check_ported(cfg: ArchConfig) -> None:
    """Refuse what the port does not compute yet, before any weight is drawn."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not yet ported (ROADMAP queue 1, "
            "'the other LM families'); "
            "the port serves the dense family")
    if cfg.moe is not None or cfg.ssm is not None or set(cfg.layer_pattern) != {"A"}:
        raise NotImplementedError(f"{cfg.name}: MoE and mamba2 layers are not yet ported "
                                  "(ROADMAP queue 1, 'the other LM families')")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend.kind} frontend is not yet "
                                  "ported (ROADMAP queue 1, 'the other LM families')")
    if cfg.parallel_block:
        raise NotImplementedError(f"{cfg.name}: parallel_block (a dry-run variant) is not yet "
                                  "ported (ROADMAP queue 1, 'sharding, dry run, mesh and "
                                  "roofline')")


def _unit_info(cfg: ArchConfig) -> Tuple[int, int]:
    unit = len(cfg.layer_pattern)
    assert cfg.n_layers % unit == 0, (cfg.n_layers, cfg.layer_pattern)
    return unit, cfg.n_layers // unit


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference. Padded logit
    columns are masked in ``forward`` and sliced off at decode."""
    return -(-cfg.vocab_size // 256) * 256


def _mask_padded_logits(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    pv = padded_vocab(cfg)
    if pv == cfg.vocab_size:
        return logits
    col = torch.arange(pv, device=logits.device)
    return logits.masked_fill(col >= cfg.vocab_size, -1e30)


def _layer_init(draw, cfg: ArchConfig, kind: str, dtype, device) -> Params:
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dtype, device),
                 "mixer": attention_init(draw, cfg, dtype)}
    if cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["ffn"] = swiglu_init(draw, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None, dtype=None) -> Params:
    """Random weights in the reference's tree layout, each drawn as
    Normal(0, 1) * scale on ``gen``'s device, cast to ``dtype`` (the
    config's by default) and moved to ``device``. Each unit position's
    leaves are allocated stacked over the repeats and filled one layer at a
    time, so the peak stays near the weights' own size plus one layer."""
    check_ported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    device = torch.device(device) if device is not None else gen.device

    def draw(d_in, d_out, dt, scale=None):
        return dense_init(gen, d_in, d_out, dt, scale=scale, device=device)

    unit, repeats = _unit_info(cfg)
    kinds = cfg.layer_kinds()
    unit_params = []
    for pos in range(unit):
        stacked = None
        for r in range(repeats):
            layer = _layer_init(draw, cfg, kinds[pos], dtype, device)
            if stacked is None:
                stacked = T.map(lambda x: torch.empty((repeats, *x.shape), dtype=x.dtype,
                                                      device=x.device), layer)
            T.map(lambda dst, src: dst[r].copy_(src), stacked, layer)
            del layer
        unit_params.append(stacked)
    params = {
        "embed": embed_init(draw, padded_vocab(cfg), cfg.d_model, dtype),
        "unit": tuple(unit_params),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": draw(cfg.d_model, padded_vocab(cfg), dtype)}
    return params


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return x @ params["lm_head"]["w"]


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    """The RoPE tables of ``positions``, made once per call for every layer."""
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.rope_theta > 0 else None


def _apply_layer_full(lp: Params, x, cfg: ArchConfig, positions, rope, cache=None):
    """One block, full sequence. With ``cache`` ({"k","v"} of one layer,
    (B, S_max, n_kv, hd)), writes this layer's roped k and v into its first
    S positions."""
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if cache is None:
        mixed = attention_apply(lp["mixer"], h, cfg, positions=positions, rope=rope)
    else:
        mixed, k, v = attention_apply(lp["mixer"], h, cfg, positions=positions, rope=rope,
                                      return_kv=True)
        S = x.shape[1]
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    x = x + mixed
    if "ffn" in lp:
        x = x + swiglu(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return x


def _layer(unit_lp: Params, r: int) -> Params:
    return T.map(lambda a: a[r], unit_lp)


def _run_layers(params: Params, cfg: ArchConfig, x: torch.Tensor, cache=None) -> torch.Tensor:
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    rope = _rope(cfg, positions)
    unit, repeats = _unit_info(cfg)
    for r in range(repeats):
        for pos in range(unit):
            c = None if cache is None else _layer(cache[pos], r)
            x = _apply_layer_full(_layer(params["unit"][pos], r), x, cfg, positions, rope, c)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            return_cache: bool = False, return_hidden: bool = False):
    """tokens: (B, S). Returns (logits, aux_loss[, cache]); with
    ``return_hidden`` the final-norm hidden states instead of logits. The
    cache is stacked over repeats, (repeats, B, S, n_kv, hd) per leaf, as the
    reference's scan stacks it. No remat: this slice runs no backward."""
    check_ported(cfg)
    x = embed_lookup(params["embed"], tokens)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, S, device=x.device) if return_cache else None
    x = _run_layers(params, cfg, x, cache)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = x if return_hidden else _mask_padded_logits(_head(params, cfg, x), cfg)
    return (out, aux, cache) if return_cache else (out, aux)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device=None) -> Any:
    check_ported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    unit, repeats = _unit_info(cfg)
    return tuple(init_attention_cache(cfg, batch, s_max, dtype, device, lead=(repeats,))
                 for _ in range(unit))


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, s_max: int
            ) -> Tuple[torch.Tensor, Any]:
    """Full-context forward that also builds the serving cache. Returns
    (last-position logits (B, V_padded), cache of ``s_max`` positions). As in
    the reference, only the last position is projected, and onto the padded
    head without masking its padded columns (``decode_step`` slices them
    off). The cache is preallocated and written layer by layer."""
    check_ported(cfg)
    x = embed_lookup(params["embed"], tokens)
    B, S, _ = x.shape
    if S > s_max:
        raise ValueError(f"prompt length {S} exceeds the cache's {s_max} positions")
    cache = init_cache(cfg, B, s_max, device=x.device)
    hidden = _run_layers(params, cfg, x, cache)
    return _head(params, cfg, hidden[:, -1, :]), cache


def decode_step(params: Params, cfg: ArchConfig, cache: Any, token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """token: (B,) integer; ``pos`` a host int. Writes the new K/V into
    ``cache`` in place and returns (logits (B, vocab_size), cache)."""
    check_ported(cfg)
    x = embed_lookup(params["embed"], token[:, None])
    rope = _rope(cfg, torch.full((1,), pos, device=x.device))  # a fill, no host-to-device copy
    unit, repeats = _unit_info(cfg)
    for r in range(repeats):
        for p_idx in range(unit):
            lp = _layer(params["unit"][p_idx], r)
            h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            mixed, _ = attention_decode(lp["mixer"], h, cfg, _layer(cache[p_idx], r), pos, rope)
            x = x + mixed
            if "ffn" in lp:
                x = x + swiglu(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x)[:, 0, : cfg.vocab_size], cache


def n_params(params: Params) -> int:
    return sum(t.numel() for t in T.leaves(params))
