"""Whisper-style encoder-decoder backbone [arXiv:2212.04356], the twin of
``repro/models/whisper.py``.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the caller hands ``encode`` precomputed frame embeddings (B,
n_ctx, d_model). Both stacks use sinusoidal positions and no RoPE. Layers
are stacked over a leading dim (``enc``: encoder layers, ``dec``: decoder
layers), as the reference's scan stacks them; a Python loop over that dim
takes the place of ``lax.scan``.

``encode`` and ``decode_full`` take ``transformer.forward``'s ``train``
flag. The prefill form (``train=False``, no gradient) sends the encoder's
self-attention (every key) and the decoder's causal self-attention through
K9 on the card; the training form (``loss_fn``) sends both through K9's
training kernels on the card in bf16 (forward and backward), the
reference's query-chunked plain attention elsewhere. Cross-attention is
always the plain path (the kernels take Sq == Sk only). Operands of two dtypes (f32
frames on bf16 weights) are promoted as in JAX (``layers.mm``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    Params,
    attention_apply,
    attention_decode,
    attention_init,
    chunked_softmax_ce,
    dense_init,
    dtype_of,
    embed_init,
    embed_lookup,
    gelu_mlp,
    gelu_mlp_init,
    init_attention_cache,
    layernorm,
    layernorm_init,
    mm,
)
from repro_torch.sharding.ctx import constrain
from repro_torch.models.transformer import (
    _layers,
    _mask_padded_logits,
    padded_vocab,
    stack_layers,
)


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    return sinusoids_at(torch.arange(length, dtype=torch.float32, device=device), channels)


def sinusoids_at(positions: torch.Tensor, channels: int) -> torch.Tensor:
    """(..., channels) f32: ``[sin, cos]`` of positions x timescales
    ``exp(-log(10000) / (channels // 2 - 1) * i)``."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=positions.device))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None, dtype=None) -> Params:
    """Random weights in the reference's tree layout ({"embed", "enc", "dec",
    "enc_norm", "dec_norm"}), drawn on ``gen``'s device layer by layer (the
    encoder's, then the decoder's, then the embedding), cast to ``dtype``
    (the config's by default) and moved to ``device``."""
    dtype = dtype or dtype_of(cfg.dtype)
    device = torch.device(device) if device is not None else gen.device
    d = cfg.d_model

    def draw(d_in, d_out, dt, scale=None):
        return dense_init(gen, d_in, d_out, dt, scale=scale, device=device)

    def enc_layer():
        return {"norm1": layernorm_init(d, dtype, device), "attn": attention_init(draw, cfg, dtype),
                "norm2": layernorm_init(d, dtype, device),
                "mlp": gelu_mlp_init(draw, d, cfg.d_ff, dtype)}

    def dec_layer():
        return {"norm1": layernorm_init(d, dtype, device),
                "self_attn": attention_init(draw, cfg, dtype),
                "norm_x": layernorm_init(d, dtype, device),
                "cross_attn": attention_init(draw, cfg, dtype),
                "norm2": layernorm_init(d, dtype, device),
                "mlp": gelu_mlp_init(draw, d, cfg.d_ff, dtype)}

    return {
        "enc": stack_layers(enc_layer, cfg.encoder.n_layers),
        "dec": stack_layers(dec_layer, cfg.n_layers),
        "embed": embed_init(draw, padded_vocab(cfg), d, dtype),
        "enc_norm": layernorm_init(d, dtype, device),
        "dec_norm": layernorm_init(d, dtype, device),
    }


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """frames: (B, n_ctx, d_model), the stubbed conv frontend's output ->
    the encoder's final-norm output in the frames' dtype (or the weights'
    where that promotes higher)."""
    S = frames.shape[1]
    x = constrain(frames + sinusoids(S, cfg.d_model, frames.device).to(frames.dtype),
                  ("batch", None, None))
    positions = torch.arange(S, device=frames.device)
    for lp in _layers(params["enc"], cfg.encoder.n_layers):
        h = layernorm(lp["norm1"], x, cfg.norm_eps)
        x = x + attention_apply(lp["attn"], h, cfg, positions=positions, causal=False,
                                train=train)
        h = layernorm(lp["norm2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def decode_full(params: Params, cfg: ArchConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
                *, return_kv: bool = False, return_hidden: bool = False, train: bool = False):
    """The decoder over the whole of ``tokens`` (B, S) against ``enc_out``.
    Returns the logits (B, S, V_padded), padded columns masked, or with
    ``return_hidden`` the final-norm hidden states; with ``return_kv`` also
    a {"k", "v"} of (n_layers, B, S, n_kv, hd). Those K/V are the
    reference's literal ones (``repro/models/whisper.py:118-122``): each
    layer's ``wk``/``wv`` applied to its MLP's normed input, not to the
    self-attention's input, so they are not the self-attention's keys."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    x = constrain(x + sinusoids(S, cfg.d_model, x.device).to(x.dtype), ("batch", None, None))
    positions = torch.arange(S, device=x.device)
    hd = cfg.resolved_head_dim
    ks, vs = [], []
    for lp in _layers(params["dec"], cfg.n_layers):
        h = layernorm(lp["norm1"], x, cfg.norm_eps)
        x = x + attention_apply(lp["self_attn"], h, cfg, positions=positions, train=train)
        hx = layernorm(lp["norm_x"], x, cfg.norm_eps)
        x = x + attention_apply(lp["cross_attn"], hx, cfg, positions=positions,
                                cross_kv=(enc_out, None), train=train)
        h = layernorm(lp["norm2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
        if return_kv:
            ks.append(mm(h, lp["self_attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, hd))
            vs.append(mm(h, lp["self_attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, hd))
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if return_kv else None
    if return_hidden:
        return (x, caches) if return_kv else x
    logits = _mask_padded_logits(mm(x, params["embed"]["table"].T), cfg)
    return (logits, caches) if return_kv else logits


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss of ``batch["tokens"]`` (B, S) given ``batch["frames"]``,
    through the training form and the chunked softmax-CE over the tied
    head. Nothing is rematerialised but the attention's query chunks and
    the CE's chunks, as in the reference (its spmd applies no remat)."""
    enc_out = encode(params, cfg, batch["frames"], train=True)
    tokens = batch["tokens"]
    hidden = decode_full(params, cfg, tokens, enc_out, return_hidden=True, train=True)
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    weights = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    weights[:, -1] = 0.0
    return chunked_softmax_ce(hidden, params["embed"]["table"].T, labels, weights,
                              cfg.vocab_size)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device=None) -> Any:
    """Zeroed {"self": {"k", "v"} (n_layers, B, s_max, n_kv, hd), "cross":
    {"k", "v"} (n_layers, B, n_ctx, n_kv, hd)} in ``dtype``."""
    dtype = dtype or dtype_of(cfg.dtype)
    self_c = init_attention_cache(cfg, batch, s_max, dtype, device, lead=(cfg.n_layers,))
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, cfg.encoder.n_ctx, cfg.n_kv_heads, hd)
    cross = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"self": self_c, "cross": cross}


def build_cross_cache(params: Params, cfg: ArchConfig, enc_out: torch.Tensor) -> Params:
    """Every decoder layer's cross-attention K/V of ``enc_out`` (B, Sk, d):
    {"k", "v"} of (n_layers, B, Sk, n_kv, hd), in the promoted dtype."""
    B, Sk, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    layers = _layers(params["dec"], cfg.n_layers)
    return {name: torch.stack([mm(enc_out, lp["cross_attn"][w]).reshape(B, Sk, cfg.n_kv_heads, hd)
                               for lp in layers])
            for name, w in (("k", "wk"), ("v", "wv"))}


def decode_step(params: Params, cfg: ArchConfig, cache: Any, token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """token: (B,) integer; ``pos`` a host int. Writes the new self-attention
    K/V into ``cache["self"]`` in place and returns (logits (B,
    vocab_size), cache); the cross K/V are read only."""
    x = embed_lookup(params["embed"], token[:, None])
    x = x + sinusoids_at(torch.full((1,), pos, device=x.device), cfg.d_model).to(x.dtype)
    self_c, cross_c = cache["self"], cache["cross"]
    for i, lp in enumerate(_layers(params["dec"], cfg.n_layers)):
        c = {"k": self_c["k"][i], "v": self_c["v"][i]}
        h = layernorm(lp["norm1"], x, cfg.norm_eps)
        mixed, _ = attention_decode(lp["self_attn"], h, cfg, c, pos)
        x = x + mixed
        hx = layernorm(lp["norm_x"], x, cfg.norm_eps)
        mixed, _ = attention_decode(lp["cross_attn"], hx, cfg, c, pos,
                                    cross_kv=(cross_c["k"][i], cross_c["v"][i]))
        x = x + mixed
        h = layernorm(lp["norm2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    logits = mm(x, params["embed"]["table"].T)
    return logits[:, 0, : cfg.vocab_size], cache
