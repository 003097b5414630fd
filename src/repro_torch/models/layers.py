"""Layer helpers, the twin of ``repro/models/layers.py``.

Parameters are plain dicts of tensors, as in the reference. Linear weights
are ``(d_in, d_out)`` and applied as ``x @ w``. The reference's sharding
constraints (``constrain``) stand where it has them: the identity without
a device mesh, a DTensor redistribution on one (``sharding/ctx.py``). On a
mesh, attention runs on each rank's own batch rows and heads
(``local_heads``), and a few ops take a form DTensor shards (``heads``,
``embed_lookup``, ``_logsumexp``, ``_gather_last``); a plain tensor takes
the one-card path unchanged.
Where the reference wraps a block in ``jax.checkpoint``, the port uses
``torch.utils.checkpoint`` without re-entry (``remat``). Where a product's
operands differ in dtype (whisper's f32 frames on bf16 weights), ``mm`` and
``promoted`` follow JAX's type promotion, which ``torch.matmul`` and
``torch.einsum`` do not.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch import tracing
from repro_torch.kernels.flash_attention.flash_attention import TRAIN_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import attention_train_op, gqa_attention_op
from repro_torch.sharding.ctx import constrain, placed_like, reduce_partial, settle

Params = dict


def remat(fn: Callable, *args, context_fn: Optional[Callable] = None):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of saved (the reference's ``jax.checkpoint``). Non-re-entrant,
    so tensors ``fn`` closes over get their gradients and views stay views;
    the blocks draw no random numbers, so no RNG state is kept.
    ``context_fn`` (a selective checkpoint's contexts) keeps what its
    policy names."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn or noop_context_fn)


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their common dtype under type promotion, as JAX
    promotes an operation's operands (bf16 with f32 is f32)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted dtype (JAX's f32 @ bf16 is f32)."""
    if a.dtype != b.dtype:
        a, b = promoted(a, b)
    return a @ b


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


def layernorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32 with the population variance (``jnp.var``), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


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
# Attention (GQA; full-sequence self-attention through K9 and its training
# form, the rest plain)
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


def heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) as (B, S, n, hd). On a mesh, a last dim sharded over a
    mesh dim that does not divide ``n`` is gathered first (DTensor cannot
    split a shard across a head; the reference's constraint then leaves
    the heads whole too)."""
    if isinstance(t, DTensor):
        want = [Replicate() if p.is_shard(t.ndim - 1) and n % t.device_mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(t.device_mesh, want)
    return t.reshape(*t.shape[:-1], n, hd)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _sdpa_block(q, k, v, mask, scale):
    """q: (B,Sq,H,D), k/v: (B,Sk,H,D), mask: (Sq,Sk) or (B,1,Sq,Sk) bool, or
    None for every key. The scale and the mask go in place on the f32
    scores (neither one's backward reads them): two f32 (Sq, Sk) tiles
    fewer a block. Operands of two dtypes are promoted, as in JAX; the
    probabilities take q's own dtype."""
    qp, k = promoted(q, k)
    scores = torch.einsum("bqhd,bkhd->bhqk", qp, k).float().mul_(scale)
    if mask is not None:
        scores = scores.masked_fill_(~mask, -1e30)
    probs, v = promoted(torch.softmax(scores, dim=-1).to(q.dtype), v)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


Q_CHUNK = 1024  # the plain path's query rows a block (the reference's default)


def fused_attention_applies(q, k, cfg) -> bool:
    """Whether the training form takes the hand-written kernels
    (``attention_train_op``): bf16 self-attention (Sq == Sk) on the card,
    or on a dry run's meta twins of its tensors, head dim 64 or 128, no
    sliding window. Read from the tensors as they are (a mesh rank's own
    shards); positions are 0..S-1, as every full-sequence caller passes
    them."""
    return (cfg.sliding_window is None and (q.is_cuda or q.is_meta)
            and q.dtype == torch.bfloat16 and k.dtype == q.dtype
            and q.shape[-1] in TRAIN_HEAD_DIMS and q.shape[1] == k.shape[1])


def _chunked_attention(q, k, v, positions, cfg, causal: bool = True) -> torch.Tensor:
    """The training form of full-sequence attention, causal (and windowed,
    where the config has a window), or every key when not ``causal`` (then
    k and v may be longer than q: cross-attention). Where
    ``fused_attention_applies``, the hand-written flash attention and its
    backward (``attention_train_op``): grouped KV heads read in place, no
    (S, S) tile in device memory. Everywhere else the reference's path
    (``repro/models/layers.py:147-185``), plain torch on every device: k
    and v repeated to every query head, then ``_attend``: ``_sdpa_block``
    over query chunks of ``Q_CHUNK`` rows (the largest chunk that divides S
    when ``Q_CHUNK`` does not: 750 for whisper's 1,500 frames), so a
    (chunk, Sk) score tile is the largest live one; when ``q`` needs a
    gradient each chunk is recomputed in the backward pass. On a device
    mesh q, k and v are constrained to ("batch", None, "model", None) as
    the reference constrains them, k and v repeated first so that each
    rank holds its query heads' KV heads, and each rank attends over its
    own batch rows and heads (``local_heads``), by either path. A call is
    the span ``attn.fwd`` and its backward pass, any recompute of chunks
    included, the span ``attn.bwd`` (``tracing.py``)."""

    def attend(q, k, v):
        if fused_attention_applies(q, k, cfg):
            return attention_train_op(q, k, v, causal=causal)
        n_rep = q.shape[2] // k.shape[2]
        return _attend(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), positions, cfg, causal)

    with tracing.span("attn.fwd"):
        kr, vr = k, v
        if isinstance(q, DTensor):
            n_rep = cfg.n_heads // cfg.n_kv_heads
            kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        out = local_heads(attend, *_head_sharded(q, kr, vr))
    tracing.backward_span("attn.bwd", out, (q, k, v))
    return out


def _head_sharded(q, k, v):
    """q, k, v (B, S, H, hd) constrained to ("batch", None, "model", None)."""
    spec = ("batch", None, "model", None)
    return constrain(q, spec), constrain(k, spec), constrain(v, spec)


def local_heads(fn: Callable, q, k, v):
    """``fn(q, k, v)``, or on DTensors (a device mesh) ``fn`` over each rank's
    local shards, the output placed as ``q`` is: attention is local to a
    batch row and a head, so the head-sharded program needs no collective
    inside it (DTensor would otherwise decompose the score products into
    batched products over strided shards of the merged batch and head
    dims). A plain tensor runs ``fn`` as it is."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=q.device_mesh)(q, k, v)


def _attend(q, k, v, positions, cfg, causal: bool) -> torch.Tensor:
    """The query-chunked attention of ``_chunked_attention`` over k and v
    with as many heads as q."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5

    def block_mask(q_pos):
        if not causal:
            return None
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
    causal: bool = True,
    cross_kv: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    return_kv: bool = False,
    rope=None,
    train: bool = False,
):
    """Full-sequence attention, causal (``causal``) or over every key, in one
    of two forms the caller picks. Self-attention in the prefill form
    (``train=False``) goes through ``gqa_attention_op``: K9 on the card,
    its plain version on the CPU; that kernel has no backward, so its
    wrapper refuses a card input that needs a gradient. K9 has no window: a
    sliding window takes ``_chunked_attention``'s plain query-chunked path
    on every device. The training form (``train=True``) is
    ``_chunked_attention``: on the card, bf16 self-attention at head dim 64
    or 128 without a window runs K9's training form, a hand-written forward
    and backward (``attention_train_op``); the rest (the CPU, f32 models,
    windows, other head dims) the plain path, its chunks recomputed in the
    backward pass. ``cross_kv = (enc, _)`` attends to
    the encoder's output instead (whisper's decoder): k and v projected
    from ``enc``, no RoPE, every key, always on the plain path (the kernels
    take Sq == Sk only). With ``return_kv`` (self-
    attention) also returns the roped k and the v, (B, S, n_kv, hd) each,
    for the cache (the reference recomputes them; they are the same
    tensors). ``rope``: the positions' ``rope_tables``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = heads(mm(x, p["wq"]), cfg.n_heads, hd)
    if cross_kv is not None:
        enc = cross_kv[0]
        k = heads(mm(enc, p["wk"]), cfg.n_kv_heads, hd)
        v = heads(mm(enc, p["wv"]), cfg.n_kv_heads, hd)
        out = _chunked_attention(q, k, v, positions, cfg, causal=False)
        return mm(out.reshape(B, S, cfg.n_heads * hd), p["wo"])
    k = heads(mm(x, p["wk"]), cfg.n_kv_heads, hd)
    v = heads(mm(x, p["wv"]), cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    if train or cfg.sliding_window is not None:
        out = _chunked_attention(q, k, v, positions, cfg, causal=causal)
    elif isinstance(q, DTensor):  # K9 on each rank's own rows and heads
        n_rep = cfg.n_heads // cfg.n_kv_heads
        out = local_heads(lambda q, k, v: gqa_attention_op(q, k, v, causal=causal),
                          *_head_sharded(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)))
    else:
        out = gqa_attention_op(q, k, v, causal=causal)
    y = mm(out.reshape(B, S, cfg.n_heads * hd), p["wo"])
    return (y, k, v) if return_kv else y


def _decode_attend(q, k, v, n_kv: int) -> torch.Tensor:
    """One query position against (B, L, n_kv, hd) keys and values, the
    query heads grouped onto their KV head instead of a repeated copy.
    Scores and softmax in f32, the probabilities in q's dtype; operands of
    two dtypes promoted as in JAX. Returns (B, 1, n_heads * hd). On a
    mesh the K/V are repeated to every query head and each rank attends
    with its own heads (``local_heads``), as the full-sequence path does."""
    B, _, H, hd = q.shape
    if isinstance(q, DTensor):
        n_rep = H // n_kv
        return local_heads(lambda q, k, v: _decode_attend(q, k, v, q.shape[2]),
                           *_head_sharded(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)))
    qg = q.reshape(B, n_kv, H // n_kv, hd)
    qp, k = promoted(qg, k)
    scores = torch.einsum("bgrd,bkgd->bgrk", qp, k).float() * hd ** -0.5
    probs, v = promoted(torch.softmax(scores, dim=-1).to(q.dtype), v)
    return torch.einsum("bgrk,bkgd->bgrd", probs, v).reshape(B, 1, H * hd)


def attention_decode(
    p: Params,
    x: torch.Tensor,
    cfg,
    cache: Params,
    pos: int,
    rope=None,
    *,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, d); cache: {"k","v"}: (B, S_max, n_kv, hd);
    ``pos`` a host int; ``rope`` its ``rope_tables`` when the caller has
    them. The new K/V are written into the cache in place (the
    reference's ``dynamic_update_slice``); the query attends to positions
    ``0..pos`` (the reference masks the rest of ``S_max``, which adds exact
    zeros). With ``cross_kv = (k, v)`` (the encoder's precomputed K/V,
    (B, Sk, n_kv, hd)) the query, unroped, attends to all of them and the
    cache is returned untouched."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads
    q = heads(mm(x, p["wq"]), cfg.n_heads, hd)
    if cross_kv is not None:
        return mm(_decode_attend(q, cross_kv[0], cross_kv[1], n_kv), p["wo"]), cache
    if rope is None and cfg.rope_theta > 0:
        rope = rope_tables(torch.full((1,), pos, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, None, cfg.rope_theta, rope)
    k_new = apply_rope(heads(mm(x, p["wk"]), n_kv, hd), None, cfg.rope_theta, rope)
    v_new = heads(mm(x, p["wv"]), n_kv, hd)
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    lo = 0 if cfg.sliding_window is None else max(0, pos - cfg.sliding_window + 1)
    out = _decode_attend(q, cache["k"][:, lo:pos + 1], cache["v"][:, lo:pos + 1], n_kv)
    return mm(out, p["wo"]), cache


def init_attention_cache(cfg, batch: int, s_max: int, dtype, device=None,
                         lead: Tuple[int, ...] = ()) -> Params:
    """Zeroed {"k","v"}: (*lead, batch, s_max, n_kv, hd); ``lead`` is the
    stack of layers that share the cache layout (the transformer's repeats)."""
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, s_max, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs, embedding
# ---------------------------------------------------------------------------

def swiglu_init(draw, d_model: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": draw(d_model, d_ff, dtype),
        "w_up": draw(d_model, d_ff, dtype),
        "w_down": draw(d_ff, d_model, dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp_init(draw, d_model: int, d_ff: int, dtype) -> Params:
    return {"w_up": draw(d_model, d_ff, dtype), "w_down": draw(d_ff, d_model, dtype)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """No biases; ``jax.nn.gelu``'s default, the tanh approximation."""
    return mm(F.gelu(mm(x, p["w_up"]), approximate="tanh"), p["w_down"])


def embed_init(draw, vocab: int, d_model: int, dtype) -> Params:
    return {"table": draw(vocab, d_model, dtype, scale=0.02)}


def embed_lookup(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table. On a mesh (a DTensor table) the table
    is gathered along its vocab shards (one all-gather) and looked up with
    ``F.embedding``: DTensor's vocab-parallel lookup leaves a masked partial
    gradient that a tied head's plain partial one cannot join, and its
    indexing's backward is not sharded in every torch version."""
    table = p["table"]
    if isinstance(table, DTensor):
        return F.embedding(tokens, _Gathered.apply(table))
    return table[tokens]


class _Gathered(torch.autograd.Function):
    """A DTensor table gathered along its vocab shards; its gradient goes
    back through ``settle`` (scattered over the vocab, then reduced over
    the batch axes), where DTensor's own backward would reduce the whole
    table first."""

    @staticmethod
    def forward(ctx, table):
        ctx.placements = table.placements
        whole = [Replicate() if pl.is_shard(0) else pl for pl in table.placements]
        return table.redistribute(table.device_mesh, whole)

    @staticmethod
    def backward(ctx, grad):
        return settle(grad, ctx.placements)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim. On a vocab-sharded DTensor, as its
    parts: the row maxima and the sums of the shifted exponentials are
    reduced across the shards (two small all-reduces), where DTensor would
    gather the whole logits for ``torch.logsumexp``."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    m = reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    return m[..., 0] + torch.log(reduce_partial(torch.exp(logits - m).sum(dim=-1)))


def _gather_last(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: the labels' columns. A vocab-sharded
    DTensor's gather is a masked partial sum, reduced before the size-1 dim
    goes (DTensor cannot drop it from a pending mask)."""
    return reduce_partial(torch.gather(logits, -1, labels[..., None].long()))[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE. logits: (..., V) any float dtype; labels integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gather_last(logits, labels)
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
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))
    masked = torch.arange(V, device=x.device) >= vocab_limit

    def body(xc, lc, wc):
        logits = constrain((xc @ w_head).float(), ("batch", None, "model"))
        logits = logits.masked_fill(placed_like(masked, logits), -1e30)
        lse = _logsumexp(logits)
        gold = _gather_last(logits, lc)
        return ((lse - gold) * wc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n * chunk, chunk):
        total = total + remat(body, x[:, i:i + chunk], labels[:, i:i + chunk],
                              weights[:, i:i + chunk])
    return total / torch.clamp(weights.sum(), min=1.0)
