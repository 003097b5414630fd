"""Mamba-2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060], the port's copy of ``repro/models/mamba2.py``.

Train and prefill use the chunk-parallel form: a masked quadratic part
inside each chunk (plain products, every chunk at once) and a sequential
recurrence of the carried state over the chunks (a Python loop in place of
``lax.scan``). Decode keeps a constant-size (ssm, conv) state: O(1) a
token.

Two things differ from a literal copy, neither in value:

- The intra-chunk decay matrix takes its exponent under the causal mask,
  ``exp(where(q >= s, a_cum[q] - a_cum[s], -inf))``. The reference
  (``repro/models/mamba2.py:92-94``) exponentiates the whole (q, s) square
  and zeroes the upper triangle afterwards. Above the diagonal the
  exponent is a sum of |dt·A| over up to a chunk's positions; at full width
  (chunk 256, A down to -48) it overflows f32 to ``inf``, and the backward
  pass multiplies a zero cotangent by it: NaN. The forward pass is bitwise
  the same either way (``exp(-inf)`` is 0).
- The reference's multi-operand einsums are written as pairwise products in
  a fixed order: ``C·B`` over the state dim first (once per group, shared
  by its heads), then the decay, then the sum over the chunk's positions
  with ``x·dt``. ``torch.einsum`` would pick its own path, and at full
  width a bad one materialises a (b, q, s, h, p) f32 intermediate.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, rmsnorm
from repro_torch.sharding.ctx import constrain


def effective_chunk(L: int, chunk: int) -> int:
    """Largest chunk <= cfg chunk that divides L (prefill lengths vary)."""
    if L % chunk == 0:
        return chunk
    return next((c for c in range(min(chunk, L), 0, -1) if L % c == 0), L)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def mamba2_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    """Random weights drawn on ``gen``'s device as the reference draws them
    (dense weights Normal * d_in**-0.5, conv weights Normal * 0.1, dt
    log-uniform in [dt_min, dt_max] stored as its inverse softplus), cast to
    ``dtype`` and moved to ``device``. ``dt_bias``, ``A_log`` and ``D`` stay
    f32 whatever ``dtype`` is."""
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    f32 = dict(dtype=torch.float32, device=gen.device)
    in_proj = dense_init(gen, cfg.d_model, d_in_proj, dtype, device=device)
    conv_w = torch.randn((s.d_conv, conv_dim), generator=gen, **f32) * 0.1
    u = torch.rand((H,), generator=gen, **f32)
    log_min, log_max = torch.log(torch.tensor(s.dt_min)), torch.log(torch.tensor(s.dt_max))
    dt = torch.exp(u * (log_max - log_min) + log_min)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(device),  # inverse softplus
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype, device=device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, L, C), w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    L = u.shape[1]
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, H], dim=-1)


def _split_xbc(cfg, xbc):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def decay_matrix(a_cum: torch.Tensor) -> torch.Tensor:
    """``exp(a_cum[q] - a_cum[s])`` for s <= q, else 0, over the last dim
    (q). a_cum: (..., q) -> (..., q, s). The exponent is taken under the
    mask, so no masked entry is ever ``inf`` (see the module docstring)."""
    q = a_cum.shape[-1]
    idx = torch.arange(q, device=a_cum.device)
    causal = idx[:, None] >= idx[None, :]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    return torch.exp(torch.where(causal, diff, float("-inf")))


def _ssd_scan(xdt, a, Bm, Cm, h0, chunk: int):
    """Chunked SSD over the sequence dim. xdt: (b, H, L, p); a: (b, H, L);
    Bm, Cm: (b, G, L, n), one per group of H // G heads; h0: (b, H, p, n).
    Returns y: (b, H, L, p) and the final state (b, H, p, n).

    The reference's ``lax.scan`` body per chunk, split where it can be: the
    parts that do not read the carried state (the intra-chunk output and
    each chunk's own state) run for every chunk at once, and only the
    carried state's recurrence, h <- exp(sum a) h + s_c, loops over the
    chunks. Each value is the scan body's, computed the same way."""
    b, H, L, p = xdt.shape
    G, n = Bm.shape[1], Bm.shape[-1]
    rep, nc = H // G, L // chunk
    x_c = xdt.reshape(b, G, rep, nc, chunk, p)
    a_cum = torch.cumsum(a.reshape(b, G, rep, nc, chunk), dim=-1)  # (b, G, rep, nc, q)
    B_c = Bm.reshape(b, G, 1, nc, chunk, n)
    C_c = Cm.reshape(b, G, 1, nc, chunk, n)
    # intra-chunk: (C·B over n) then the decay, then the sum over s with x·dt
    scores = (C_c @ B_c.transpose(-1, -2)) * decay_matrix(a_cum)  # (b, G, rep, nc, q, s)
    y_diag = scores @ x_c
    # each chunk's own contribution to the state it hands on
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b, G, rep, nc, q)
    s_c = (x_c * decay_states[..., None]).transpose(-1, -2) @ B_c  # (b, G, rep, nc, p, n)
    chunk_decay = torch.exp(a_cum[..., -1])[..., None, None]  # (b, G, rep, nc, 1, 1)
    h = h0.reshape(b, G, rep, p, n)
    carried = []
    for c in range(nc):
        carried.append(h)
        h = chunk_decay[:, :, :, c] * h + s_c[:, :, :, c]
    h_in = torch.stack(carried, dim=3)  # the state each chunk starts from
    # the carried state's contribution
    y_off = (C_c @ h_in.transpose(-1, -2)) * torch.exp(a_cum)[..., None]
    return (y_diag + y_off).reshape(b, H, L, p), h.reshape(b, H, p, n)


def mamba2_apply(p: Params, x: torch.Tensor, cfg, return_state: bool = False):
    """Full sequence (train / prefill). x: (B, L, d_model). With
    ``return_state`` also returns the state a prefill hands to decode: the
    final SSD state (B, H, p, n) f32, from this one scan (the reference
    reruns the scan for it), and the last ``d_conv - 1`` positions of the
    pre-conv ``xbc``, (B, d_conv - 1, conv_dim) in x's dtype."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    Bsz, L, _ = x.shape
    if return_state and L < s.d_conv - 1:
        raise ValueError(f"a prompt of {L} tokens is shorter than the conv state's "
                         f"{s.d_conv - 1} positions (d_conv - 1): the decode cache "
                         "cannot be filled from it")
    chunk = effective_chunk(L, s.chunk)

    z, xbc, dt_raw = _split_proj(cfg, constrain(x @ p["in_proj"], ("batch", None, "model")))
    conv_tail = xbc[:, L - (s.d_conv - 1):, :] if return_state else None
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _split_xbc(cfg, xbc)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, L, H)
    A = -torch.exp(p["A_log"])  # (H,)
    a = (dt * A).transpose(1, 2)  # (B, H, L)

    xh = xs.reshape(Bsz, L, H, s.headdim).float()
    xdt = (xh * dt[..., None]).transpose(1, 2)  # (B, H, L, p)
    Bg = Bm.reshape(Bsz, L, s.n_groups, s.d_state).float().transpose(1, 2)  # (B, G, L, n)
    Cg = Cm.reshape(Bsz, L, s.n_groups, s.d_state).float().transpose(1, 2)

    h0 = torch.zeros((Bsz, H, s.headdim, s.d_state), dtype=torch.float32, device=x.device)
    y, h_final = _ssd_scan(xdt, a, Bg, Cg, h0, chunk)
    y = y.transpose(1, 2) + p["D"][:, None] * xh  # (B, L, H, p)
    y = y.reshape(Bsz, L, d_inner).to(x.dtype)

    y = rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    out = y @ p["out_proj"]
    return (out, h_final, conv_tail) if return_state else out


def init_mamba_cache(cfg, batch: int, dtype, device=None, lead: Tuple[int, ...] = ()) -> Params:
    """Zeroed {"ssm": (*lead, batch, H, p, n) f32, "conv": (*lead, batch,
    d_conv - 1, conv_dim) in ``dtype``}; ``lead`` as in
    ``layers.init_attention_cache``."""
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((*lead, batch, H, s.headdim, s.d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_decode(p: Params, x: torch.Tensor, cfg, cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model). Returns the output and the new
    {"ssm", "conv"} (``conv`` a view into a concatenation: the caller
    copies it into its cache)."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    Bsz = x.shape[0]

    z, xbc, dt_raw = _split_proj(cfg, x @ p["in_proj"])  # (B, 1, *)
    window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)  # (B, K, C)
    conv_out = (window * p["conv_w"]).sum(1) + p["conv_b"]
    xbc = F.silu(conv_out)[:, None, :]
    new_conv = window[:, 1:, :]

    xs, Bm, Cm = _split_xbc(cfg, xbc)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # (B, H)

    rep = H // s.n_groups
    Bh = Bm[:, 0].reshape(Bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1).float()
    Ch = Cm[:, 0].reshape(Bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1).float()
    xh = xs[:, 0].reshape(Bsz, H, s.headdim).float()

    h = cache["ssm"] * a[..., None, None] + (dt[..., None] * xh)[..., None] * Bh[:, :, None, :]
    y = (h @ Ch[..., None])[..., 0] + p["D"][:, None] * xh  # (B, H, p)
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)

    y = rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    return y @ p["out_proj"], {"ssm": h, "conv": new_conv}
