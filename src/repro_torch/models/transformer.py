"""Decoder stack for the dense, moe, ssm, hybrid and vlm families:
full-sequence ``forward`` and the next-token ``loss_fn`` (train),
``prefill`` (forward + cache build) and ``decode_step`` (one token against
the cache). The audio family (whisper) is ``models/whisper.py``.

The reference's stacked layout is kept: layers are grouped by the repeating
``layer_pattern`` unit ('A' attention, 'M' mamba2) and each unit position's
leaves carry a leading ``repeats`` dimension. A Python loop over the repeats
takes the place of ``lax.scan``, so weights carried across from the JAX
package (``interop.lm_params_from_numpy``) are used as they are. A layer's
FFN is MoE where ``cfg.is_moe_layer`` holds of its **unit position**, as in
the reference (``repro/models/transformer.py:70, 136, 331, 340``), and the
MoE layers' load-balance losses are summed into ``aux``.

Two variants of the reference's §Perf work compute here too. With
``cfg.parallel_block`` an attention layer with an FFN is PaLM's block: one
shared pre-norm, the attention and the FFN added together (``forward``,
``loss_fn``, ``prefill``, ``decode_step``). ``remat_policy="save_comm"``
keeps each unit's attention and FFN outputs through the backward pass and
recomputes the rest (``save_comm_contexts``).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2
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
    init_attention_cache,
    remat,
    rmsnorm,
    rmsnorm_init,
    rope_tables,
    swiglu,
    swiglu_init,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.sharding.ctx import constrain, distribute


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


def _layer_init(gen: torch.Generator, cfg: ArchConfig, kind: str, pos: int, dtype,
                device) -> Params:
    """One layer at unit position ``pos``: an attention or mamba2 mixer, then
    (when the config has one) a SwiGLU or, where ``cfg.is_moe_layer(pos)``,
    an MoE FFN."""
    def draw(d_in, d_out, dt, scale=None):
        return dense_init(gen, d_in, d_out, dt, scale=scale, device=device)

    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dtype, device)}
    if kind == "A":
        p["mixer"] = attention_init(draw, cfg, dtype)
    else:
        p["mixer"] = mamba2.mamba2_init(gen, cfg, dtype, device)
    if cfg.d_ff > 0 or cfg.moe is not None:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        if cfg.is_moe_layer(pos):
            p["ffn"] = moe_init(gen, cfg, dtype, device)
        else:
            p["ffn"] = swiglu_init(draw, cfg.d_model, cfg.d_ff, dtype)
    return p


def stack_layers(make_layer: Callable[[], Params], n: int) -> Params:
    """``n`` layers from ``make_layer()``, each leaf stacked over a leading
    dim of ``n``: the stack is allocated at the first layer and filled one
    layer at a time, so the peak stays near the stack's own size plus one
    layer (the reference stacks a list of whole layers)."""
    stacked = None
    for r in range(n):
        layer = make_layer()
        if stacked is None:
            stacked = T.map(lambda x: torch.empty((n, *x.shape), dtype=x.dtype,
                                                  device=x.device), layer)
        T.map(lambda dst, src: dst[r].copy_(src), stacked, layer)
        del layer
    return stacked


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None, dtype=None) -> Params:
    """Random weights in the reference's tree layout, each drawn on
    ``gen``'s device as the reference draws it, cast to ``dtype`` (the
    config's by default; mamba2's ``A_log``, ``dt_bias``, ``D`` and the MoE
    router stay f32) and moved to ``device``. Each unit position's
    leaves are stacked over the repeats (``stack_layers``). A vision
    frontend adds ``projector.w`` (d_model, d_model), drawn after the head
    from the same generator (the reference draws it on its ``lm_head``'s
    key)."""
    dtype = dtype or dtype_of(cfg.dtype)
    device = torch.device(device) if device is not None else gen.device

    def draw(d_in, d_out, dt, scale=None):
        return dense_init(gen, d_in, d_out, dt, scale=scale, device=device)

    unit, repeats = _unit_info(cfg)
    kinds = cfg.layer_kinds()
    params = {
        "unit": tuple(stack_layers(lambda: _layer_init(gen, cfg, kinds[pos], pos, dtype, device),
                                   repeats) for pos in range(unit)),
        "embed": embed_init(draw, padded_vocab(cfg), cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": draw(cfg.d_model, padded_vocab(cfg), dtype)}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        params["projector"] = {"w": draw(cfg.d_model, cfg.d_model, dtype)}
    return params


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return x @ params["lm_head"]["w"]


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    """The RoPE tables of ``positions``, made once per call for every layer."""
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.rope_theta > 0 else None


REMAT_POLICIES = ("full", "save_comm")


def check_remat_policy(policy: str) -> None:
    """``"full"`` recomputes a whole unit; ``"save_comm"`` keeps each
    unit's attention and FFN outputs (``save_comm_contexts``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of {REMAT_POLICIES}")


def _parallel(cfg: ArchConfig, kind: str, lp: Params) -> bool:
    """PaLM's block for an attention layer with an FFN (the reference's test)."""
    return cfg.parallel_block and kind == "A" and "ffn" in lp


# "save_comm"'s two named outputs, as the reference names them with
# ``checkpoint_name`` (``repro/models/transformer.py:145-150, 247-251``):
# "attn_out" the mixer's output (attention or mamba2), "ffn_out" the FFN's,
# and for a parallel layer "attn_out" the sum of both branches.
#
# A selective-checkpoint policy sees aten ops, not names, so each named
# output is told apart by the op that produces it. The mixer's and the FFN's
# are the products with their output weights (``wo``, ``out_proj``,
# ``w_down``; an MoE layer's expert ``bmm`` and its shared expert's product
# both read a ``w_down``): the policy keeps an ``mm``/``bmm`` whose operand
# *is* one of the unit's output weights, tensor identity, which costs
# nothing. A parallel layer's sum reads no weight, so ``_named_sum`` raises
# a thread-local flag for the one ``add`` it runs. (An identity op made
# with ``torch.library.custom_op`` would name any tensor, but it may not
# return an alias of its input and so costs a copy of each.) For an MoE
# layer the kept tensor is the expert products' (E, capacity, d) output,
# from which the un-route (a gather, the gates' product, a permutation and
# the sum over k) is recomputed, not the (B, S, d) sum the reference keeps.
_NAMED = threading.local()
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _named_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b``, the one op a "save_comm" policy keeps of a parallel layer."""
    _NAMED.on = True
    try:
        return a + b
    finally:
        _NAMED.on = False


def _output_weights(cfg: ArchConfig, unit_layers) -> list:
    """The weights whose products give a unit's named outputs: every
    sequential layer's ``wo`` or ``out_proj`` and its FFN's ``w_down``."""
    kinds = cfg.layer_kinds()
    out = []
    for pos, lp in enumerate(unit_layers):
        if _parallel(cfg, kinds[pos], lp):
            continue
        out.append(lp["mixer"]["wo" if kinds[pos] == "A" else "out_proj"])
        ffn = lp.get("ffn", {})
        out += [f["w_down"] for f in (ffn, ffn.get("shared", {})) if "w_down" in f]
    return out


def save_comm_contexts(weights) -> Tuple[Any, Any]:
    """The selective checkpoint's (forward, recompute) contexts for one unit
    under ``remat_policy="save_comm"``: its named outputs (above) are
    ``MUST_SAVE``, every other op ``PREFER_RECOMPUTE``. Built anew for each
    unit, as ``torch.utils.checkpoint`` asks.

    The reference keeps these outputs so that its backward pass does not
    replay the tensor-parallel all-reduce that follows each of them. On one
    card there is no collective: the variant changes what is stored (two
    activations a layer more) and which products the recompute skips, never
    a value; the gradients are those of full remat. The non-reentrant
    recompute stops once it has made the last tensor the backward pass
    needs, so it never reaches a unit's last output (its last layer's FFN
    output, or that layer's sum where it is a parallel one) under either
    policy: keeping that one costs its memory and skips nothing, while
    keeping a mixer's output skips its ``wo`` or ``out_proj`` product."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    ids = {id(w) for w in weights}

    def policy(ctx, op, *args, **kwargs):
        if getattr(_NAMED, "on", False) or (
                op in _PRODUCTS and any(id(a) in ids for a in args)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _ffn(lp: Params, h: torch.Tensor, cfg: ArchConfig, pos: int):
    """The layer's FFN on its normed input: (y, aux), aux None unless MoE."""
    if cfg.is_moe_layer(pos):
        return moe_apply(lp["ffn"], h, cfg)
    return swiglu(lp["ffn"], h), None


def _mixer_full(lp: Params, h, cfg: ArchConfig, kind: str, positions, rope, cache, train):
    """The layer's mixer on its normed input ``h``, full sequence; with
    ``cache`` writes the layer's prefill state in place."""
    if kind == "A" and cache is None:
        return attention_apply(lp["mixer"], h, cfg, positions=positions, rope=rope, train=train)
    if kind == "A":
        mixed, k, v = attention_apply(lp["mixer"], h, cfg, positions=positions, rope=rope,
                                      return_kv=True)
        S = h.shape[1]
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        return mixed
    if cache is None:
        return mamba2.mamba2_apply(lp["mixer"], h, cfg)
    mixed, ssm, conv = mamba2.mamba2_apply(lp["mixer"], h, cfg, return_state=True)
    cache["ssm"].copy_(ssm)
    cache["conv"].copy_(conv)
    return mixed


def _apply_layer_full(lp: Params, x, cfg: ArchConfig, kind: str, pos: int, positions, rope,
                      cache=None, train: bool = False):
    """One block at unit position ``pos``, full sequence. Returns (x, aux),
    aux None when the layer has no MoE. With ``cache`` (this layer's slice
    of the stacked cache) writes its prefill state in place: an attention
    layer's roped k and v into the first S positions, a mamba2 layer's
    final SSD state and pre-conv tail. ``train`` picks the training form of
    attention. A parallel layer (``_parallel``) returns ``x + (mixed + y)``
    with both branches on the one pre-norm, the reference's order
    (``repro/models/transformer.py:173``); its ``norm2`` is read by
    nothing."""
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    mixed = _mixer_full(lp, h, cfg, kind, positions, rope, cache, train)
    if _parallel(cfg, kind, lp):
        y, aux = _ffn(lp, h, cfg, pos)
        return x + _named_sum(mixed, y), aux
    # on a mesh the row-parallel output product is a pending sum over
    # "model": it is reduced where it meets the residual (the tensor-parallel
    # all-reduce), so the norm after it sees whole rows
    x = x + constrain(mixed, ("batch", None, None))
    aux = None
    if "ffn" in lp:
        y, aux = _ffn(lp, rmsnorm(lp["norm2"], x, cfg.norm_eps), cfg, pos)
        x = x + y
    return x, aux


def _layer(unit_lp: Params, r: int) -> Params:
    return T.map(lambda a: a[r], unit_lp)


def _layers(unit_lp: Params, repeats: int):
    """Every repeat's tree of one unit position, from one ``unbind`` of each
    stacked leaf: in the backward pass the layers' gradients are stacked
    once, where indexing each repeat would add a leaf-sized gradient a
    layer."""
    parts = [_unsharded_dim0(a).unbind(0) for a in T.leaves(unit_lp)]
    return [T.unflatten(unit_lp, [p[r] for p in parts]) for r in range(repeats)]


def _unsharded_dim0(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a DTensor sharded on its repeats dim gathered along it (the
    reference's MoE rule, read with a replica dim in front, takes a dense
    FFN's (R, repeats, f, d) stack for an expert stack and shards the
    repeats over "model"; its scan gathers them as this does)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(a, DTensor) or not any(p.is_shard(0) for p in a.placements):
        return a
    return a.redistribute(a.device_mesh, [Replicate() if p.is_shard(0) else p
                                          for p in a.placements])


def _run_layers(params: Params, cfg: ArchConfig, x: torch.Tensor, cache=None,
                train: bool = False, remat_units: bool = False, remat_policy: str = "full"):
    """The stack, repeat by repeat. Returns the final-norm hidden states
    and ``aux``, the MoE layers' losses summed in the reference's order (f32
    scalar; 0 without MoE). ``remat_units`` recomputes each repeat's unit
    in the backward pass (the reference's ``jax.checkpoint(unit_body)``
    inside its scan): under ``remat_policy`` "full" a unit's input is the
    only activation it keeps, under "save_comm" its named outputs too."""
    S = x.shape[1]
    x = constrain(x, ("batch", None, None))
    positions = torch.arange(S, device=x.device)
    rope = _rope(cfg, positions)
    unit, repeats = _unit_info(cfg)
    kinds = cfg.layer_kinds()
    layers = [_layers(params["unit"][pos], repeats) for pos in range(unit)]

    def unit_body(x, aux, r):
        for pos in range(unit):
            c = None if cache is None else _layer(cache[pos], r)
            x, a = _apply_layer_full(layers[pos][r], x, cfg, kinds[pos], pos, positions, rope,
                                     c, train)
            x = constrain(x, ("batch", None, None))
            if a is not None:
                aux = aux + a
        return x, aux

    def contexts(r):
        if remat_policy != "save_comm":
            return None
        return lambda: save_comm_contexts(_output_weights(cfg, [lp[r] for lp in layers]))

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(repeats):
        x, aux = remat(unit_body, x, aux, r, context_fn=contexts(r)) if remat_units \
            else unit_body(x, aux, r)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def embed_inputs(params: Params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tokens' embeddings, (B, S, d), with ``prefix_embeds`` (B, P, d)
    (a vision frontend's stubbed patch embeddings) cast to the model's
    dtype, projected where the tree has a ``projector`` and prepended:
    (B, P + S, d)."""
    x = embed_lookup(params["embed"], tokens)
    if prefix_embeds is None:
        return x
    pe = prefix_embeds.to(x.dtype)
    if "projector" in params:
        pe = pe @ params["projector"]["w"]
    return torch.cat([pe, x], dim=1)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            train: bool = False, remat: bool = False, remat_policy: str = "full",
            return_cache: bool = False, return_hidden: bool = False):
    """tokens: (B, S). Returns (logits, aux_loss[, cache]); with
    ``return_hidden`` the final-norm hidden states instead of logits. With
    ``prefix_embeds`` (B, P, d) the sequence is the projected prefix, then
    the tokens (``embed_inputs``), positions 0..P+S-1 over both. The cache
    is stacked over repeats, as the reference's scan stacks it:
    (repeats, B, S, n_kv, hd) per attention leaf, ``init_mamba_cache``'s
    layout for a mamba2 position.

    ``train`` picks the training form of attention (differentiable: K9's
    training kernels on the card for bf16 self-attention at head dim 64 or
    128 without a window, the reference's query-chunked plain attention
    otherwise) over the prefill form (K9 on the card, whose prefill
    wrapper has no backward); the caller asks
    for it, it is never inferred from the inputs. ``remat`` (training form
    only) recomputes each unit in the backward pass, all of it under
    ``remat_policy`` "full", all but its named outputs under "save_comm"."""
    if remat:
        check_remat_policy(remat_policy)
        if not train:
            raise ValueError("remat recomputes the training form: pass train=True")
    x = embed_inputs(params, tokens, prefix_embeds)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, S, device=x.device) if return_cache else None
    x, aux = _run_layers(params, cfg, x, cache, train=train, remat_units=remat,
                         remat_policy=remat_policy)
    out = x if return_hidden else _mask_padded_logits(_head(params, cfg, x), cfg)
    return (out, aux, cache) if return_cache else (out, aux)


def loss_fn(params: Params, cfg: ArchConfig, batch, *, remat: bool = False,
            remat_policy: str = "full", ce_chunk: int = 512) -> torch.Tensor:
    """Next-token LM loss through the training form, with the chunked
    softmax-CE (the (B, S, V) logits never exist), plus the MoE layers'
    load-balance ``aux``. batch: {"tokens": (B, S)[, "prefix_embeds": (B,
    P, d)]}; the prefix's P hidden rows carry no loss. Position t predicts
    token t + 1; the last position has weight 0. The head is the embedding
    table's transpose when tied."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    hidden, aux = forward(params, cfg, tokens, prefix_embeds=prefix, train=True, remat=remat,
                          remat_policy=remat_policy, return_hidden=True)
    hidden = hidden[:, 0 if prefix is None else prefix.shape[1]:]
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    weights = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    weights[:, -1] = 0.0
    head = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return chunked_softmax_ce(hidden, head, labels, weights, cfg.vocab_size,
                              chunk=ce_chunk) + aux


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device=None) -> Any:
    """A zeroed serving cache, one entry a unit position, stacked over the
    repeats: an attention position's {"k", "v"} of ``s_max`` positions in
    ``dtype``, a mamba2 position's {"ssm" (f32), "conv" (``dtype``)}."""
    dtype = dtype or dtype_of(cfg.dtype)
    unit, repeats = _unit_info(cfg)
    return tuple(init_attention_cache(cfg, batch, s_max, dtype, device, lead=(repeats,))
                 if kind == "A" else
                 mamba2.init_mamba_cache(cfg, batch, dtype, device, lead=(repeats,))
                 for kind in cfg.layer_kinds()[:unit])


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, s_max: int, *,
            prefix_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Any]:
    """Full-context forward that also builds the serving cache. Returns
    (last-position logits (B, V_padded), cache of ``s_max`` positions). As in
    the reference, only the last position is projected, and onto the padded
    head without masking its padded columns (``decode_step`` slices them
    off). The cache is preallocated and written layer by layer. A mamba2
    layer needs at least ``d_conv - 1`` prompt tokens for its conv state.
    ``prefix_embeds`` as in ``forward``: the cache then holds the prefix's
    P positions before the tokens', and decoding goes on at P + S."""
    x = embed_inputs(params, tokens, prefix_embeds)
    B, S, _ = x.shape
    if S > s_max:
        raise ValueError(f"prompt length {S} exceeds the cache's {s_max} positions")
    cache = init_cache(cfg, B, s_max, device=x.device)
    if isinstance(x, DTensor):
        cache = _cache_on_mesh(cache, x.device_mesh)
    hidden, _ = _run_layers(params, cfg, x, cache)
    return _head(params, cfg, hidden[:, -1, :]), cache


# the serving cache's placements on a mesh, by leaf: (repeats, B, S, kv, hd)
# attention K/V, (repeats, B, H, p, n) SSD state, (repeats, B, K, C) conv tail
_CACHE_SPECS = {"k": (None, "batch", None, "model", None),
                "v": (None, "batch", None, "model", None),
                "ssm": (None, "batch", "model", None, None),
                "conv": (None, "batch", None, "model")}


def _cache_on_mesh(cache, device_mesh):
    """The zeroed cache as DTensors on the prefill's mesh: the batch over
    the batch axes, heads (or channels) over "model" where they divide."""
    return tuple({k: distribute(t, _CACHE_SPECS[k], device_mesh) for k, t in c.items()}
                 for c in cache)


def decode_step(params: Params, cfg: ArchConfig, cache: Any, token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """token: (B,) integer; ``pos`` a host int (read by attention layers
    only). Writes the new K/V, or a mamba2 layer's new state, into
    ``cache`` in place and returns (logits (B, vocab_size), cache)."""
    x = embed_lookup(params["embed"], token[:, None])
    rope = _rope(cfg, torch.full((1,), pos, device=x.device))  # a fill, no host-to-device copy
    unit, repeats = _unit_info(cfg)
    kinds = cfg.layer_kinds()
    for r in range(repeats):
        for p_idx in range(unit):
            lp, c = _layer(params["unit"][p_idx], r), _layer(cache[p_idx], r)
            h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            if kinds[p_idx] == "A":
                mixed, _ = attention_decode(lp["mixer"], h, cfg, c, pos, rope)
            else:
                mixed, new = mamba2.mamba2_decode(lp["mixer"], h, cfg, c)
                c["ssm"].copy_(new["ssm"])
                c["conv"].copy_(new["conv"])
            if _parallel(cfg, kinds[p_idx], lp):
                # (x + mixed) + y: the reference's decode order (:335), not
                # the full-sequence form's x + (mixed + y)
                x = x + mixed + _ffn(lp, h, cfg, p_idx)[0]
                continue
            x = x + mixed
            if "ffn" in lp:
                x = x + _ffn(lp, rmsnorm(lp["norm2"], x, cfg.norm_eps), cfg, p_idx)[0]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x)[:, 0, : cfg.vocab_size], cache


def n_params(params: Params) -> int:
    return sum(t.numel() for t in T.leaves(params))
