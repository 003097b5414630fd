"""Layer helpers (the parts of ``repro/models/layers.py`` that DLRM and the
LM serving and training paths need).

Parameters are plain dicts of tensors, as in the reference. Linear weights
are ``(d_in, d_out)`` and applied as ``x @ w``. The reference's sharding
constraints (``constrain``) are identity without a mesh and are dropped;
``layernorm`` and ``gelu_mlp`` wait for the slice that uses them. Where the
reference wraps a block in ``jax.checkpoint``, the port uses
``torch.utils.checkpoint`` without re-entry (``remat``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import gqa_attention_op

Params = dict


def remat(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of saved (the reference's ``jax.checkpoint``). Non-re-entrant,
    so tensors ``fn`` closes over get their gradients and views stay views;
    the blocks draw no random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Normal(0, 1) * d_in**-0.5, drawn from ``gen`` on the generator's own
    device (a CPU generator gives weights that do not depend on the device
    they are moved to), cast to ``dtype`` and moved to ``device``."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of positions x frequencies, (..., S, 1, D/2) each. A model
    computes them once per call and hands them to every layer (the
    reference's jit hoists them; eager PyTorch would redo them per layer)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer; ``tables`` the
    positions' ``rope_tables`` when the caller has them."""
    if theta <= 0:
        return x
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal; full-sequence through K9, one-token decode plain)
# ---------------------------------------------------------------------------

def attention_init(draw, cfg, dtype) -> Params:
    """``draw(d_in, d_out, dtype)`` makes one dense weight (layers.dense_init
    with the caller's generator and device)."""
    hd = cfg.resolved_head_dim
    return {
        "wq": draw(cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": draw(cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wv": draw(cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wo": draw(cfg.n_heads * hd, cfg.d_model, dtype),
    }


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _sdpa_block(q, k, v, mask, scale):
    """q: (B,Sq,H,D), k/v: (B,Sk,H,D), mask: (Sq,Sk) or (B,1,Sq,Sk) bool.
    The scale and the mask go in place on the f32 scores (neither one's
    backward reads them): two f32 (Sq, Sk) tiles fewer a block."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float().mul_(scale)
    scores = scores.masked_fill_(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


Q_CHUNK = 1024  # the plain path's query rows a block (the reference's default)


def _chunked_attention(q, k, v, positions, cfg) -> torch.Tensor:
    """The reference's full-sequence path (``repro/models/layers.py:147-185``):
    ``_sdpa_block`` over query chunks of ``Q_CHUNK`` rows (the largest chunk
    that divides S when ``Q_CHUNK`` does not), so a (chunk, S) score tile is
    the largest live one; when ``q`` needs a gradient each chunk is
    recomputed in the backward pass. Plain torch, differentiable on every
    device, with or without a sliding window."""
    B, S, H, hd = q.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = hd ** -0.5

    def block_mask(q_pos):
        m = q_pos[:, None] >= positions[None, :]
        if cfg.sliding_window is not None:
            m &= q_pos[:, None] - positions[None, :] < cfg.sliding_window
        return m

    q_chunk = Q_CHUNK
    if S % q_chunk:
        q_chunk = next((c for c in range(min(q_chunk, S), 0, -1) if S % c == 0), S)
    if S <= q_chunk:
        return _sdpa_block(q, k, v, block_mask(positions), scale)

    def body(qi, pi):
        return _sdpa_block(qi, k, v, block_mask(pi), scale)

    def run(qi, pi):
        return remat(body, qi, pi) if qi.requires_grad else body(qi, pi)

    outs = [run(q[:, i:i + q_chunk], positions[i:i + q_chunk]) for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_apply(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    return_kv: bool = False,
    rope=None,
    train: bool = False,
):
    """Full-sequence causal self-attention after RoPE, in one of two forms
    the caller picks. The prefill form (``train=False``) goes through
    ``gqa_attention_op``: K9 on the card, its plain version on the CPU; K9
    has no backward, so its wrapper refuses a card input that needs a
    gradient. K9 has no window: a sliding window takes the reference's
    query-chunked plain path (``_chunked_attention``) on every device. The
    training form (``train=True``) is that path too, windowed or not, its
    chunks recomputed in the backward pass. With ``return_kv`` also returns
    the roped k and the v, (B, S, n_kv, hd) each, for the cache (the
    reference recomputes them; they are the same tensors). ``rope``: the
    positions' ``rope_tables``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    if train or cfg.sliding_window is not None:
        out = _chunked_attention(q, k, v, positions, cfg)
    else:
        out = gqa_attention_op(q, k, v, causal=True)
    y = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    return (y, k, v) if return_kv else y


def attention_decode(
    p: Params,
    x: torch.Tensor,
    cfg,
    cache: Params,
    pos: int,
    rope=None,
) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, d); cache: {"k","v"}: (B, S_max, n_kv, hd);
    ``pos`` a host int; ``rope`` its ``rope_tables`` when the caller has
    them. The new K/V are written into the cache in place (the
    reference's ``dynamic_update_slice``); the query attends to positions
    ``0..pos`` (the reference masks the rest of ``S_max``, which adds exact
    zeros), with the query heads grouped onto their KV head instead of a
    repeated copy of the cache."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads
    n_rep = cfg.n_heads // n_kv
    if rope is None and cfg.rope_theta > 0:
        rope = rope_tables(torch.full((1,), pos, device=x.device), hd, cfg.rope_theta)
    q = apply_rope((x @ p["wq"]).reshape(B, 1, cfg.n_heads, hd), None, cfg.rope_theta, rope)
    k_new = apply_rope((x @ p["wk"]).reshape(B, 1, n_kv, hd), None, cfg.rope_theta, rope)
    v_new = (x @ p["wv"]).reshape(B, 1, n_kv, hd)
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    lo = 0 if cfg.sliding_window is None else max(0, pos - cfg.sliding_window + 1)
    k, v = cache["k"][:, lo:pos + 1], cache["v"][:, lo:pos + 1]  # (B, L, n_kv, hd)
    qg = q.reshape(B, n_kv, n_rep, hd)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg, k).float() * hd ** -0.5
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, v)
    return out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"], cache


def init_attention_cache(cfg, batch: int, s_max: int, dtype, device=None,
                         lead: Tuple[int, ...] = ()) -> Params:
    """Zeroed {"k","v"}: (*lead, batch, s_max, n_kv, hd); ``lead`` is the
    stack of layers that share the cache layout (the transformer's repeats)."""
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, s_max, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------

def swiglu_init(draw, d_model: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": draw(d_model, d_ff, dtype),
        "w_up": draw(d_model, d_ff, dtype),
        "w_down": draw(d_ff, d_model, dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def embed_init(draw, vocab: int, d_model: int, dtype) -> Params:
    return {"table": draw(vocab, d_model, dtype, scale=0.02)}


def embed_lookup(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE. logits: (..., V) any float dtype; labels integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def chunked_softmax_ce(
    x: torch.Tensor,
    w_head: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    vocab_limit: int,
    chunk: int = 512,
) -> torch.Tensor:
    """Chunked softmax-CE: the (B, S, V) logits are never materialised.
    Sequence chunks of ``chunk`` positions (S padded up to a multiple) each
    compute their (B, chunk, V) logits in ``x``'s dtype, then in f32, and
    are recomputed in the backward pass. x: (B, S, d); w_head: (d,
    V_padded); labels/weights: (B, S). Columns at or above ``vocab_limit``
    (padding) are masked out. The weighted sum over chunks, in order, is
    divided by ``max(sum(weights), 1)``."""
    B, S, _ = x.shape
    V = w_head.shape[-1]
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    masked = torch.arange(V, device=x.device) >= vocab_limit

    def body(xc, lc, wc):
        logits = (xc @ w_head).float().masked_fill(masked, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return ((lse - gold) * wc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n * chunk, chunk):
        total = total + remat(body, x[:, i:i + chunk], labels[:, i:i + chunk],
                              weights[:, i:i + chunk])
    return total / torch.clamp(weights.sum(), min=1.0)
