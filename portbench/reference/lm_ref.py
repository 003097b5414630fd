"""Plain PyTorch reference of the LM cohort's first training steps and its
first EASGD sync.

The model is a pre-norm decoder (MiniCPM's block, arXiv:2404.06395, as a
llama-like stack): RMSNorm (the configuration's eps) with a learned scale, multi-head
attention with rotary embeddings on the two halves of each head (theta
10,000), causal, scale head_dim**-0.5; a SwiGLU MLP; a final RMSNorm; the
head is the embedding table's transpose (tied), over the real vocabulary
(the table's padding rows are never read by a logit). The loss is the mean
next-token cross-entropy over positions 0..S-2.

Weights are stored in the configuration's dtype (bf16) and every product
is computed in float32 from them (TF32 off); Adam (b1 0.9, b2 0.999, eps
1e-8 inside the root, as eps**2 on the bias-corrected second moment) keeps
f32 moments and writes each step back in bf16: p - bf16(lr * update).
After ``steps`` steps the sync lands once on every replica in order: the
PS moves toward replica i, then replica i toward the moved PS (f32 lerps,
stored in bf16). Replicas are independent until the sync, so they are
computed one after another. Each layer and each slice of the loss is
recomputed in the backward pass to fit the card.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 e4m3, and its backward's incoming gradient to e5m2, a scale a
tensor, before the f32 product (``lowp.mm``). ``fault`` plants one of the
faults the check must catch.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import data, lowp

LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "norm1", "norm2")
B1, B2, EPS = 0.9, 0.999, 1e-8
CE_CHUNK, Q_CHUNK = 512, 512
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_mm(precision: str) -> Callable:
    if precision == "fp8":
        return lambda a, b: lowp.mm(a, b, lowp.e4m3, lowp.e5m2)
    return lambda a, b: a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, mm):
    """q, k, v: (B, H, S, hd), causal, over query chunks."""
    S, hd = q.shape[2], q.shape[3]
    outs = []
    for i in range(0, S, Q_CHUNK):
        qi = q[:, :, i:i + Q_CHUNK]
        s = mm(qi, k.transpose(-1, -2)) * hd ** -0.5
        qpos = torch.arange(i, i + qi.shape[2], device=q.device)
        mask = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(mm(torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=2)


def _layer(x, lw, cos, sin, cfg, mm):
    Bsz, S, d = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = _rms(x, lw["norm1"], cfg["norm_eps"])
    q = _rope(mm(h, lw["wq"]).view(Bsz, S, H, hd), cos, sin)
    k = _rope(mm(h, lw["wk"]).view(Bsz, S, KV, hd), cos, sin)
    v = mm(h, lw["wv"]).view(Bsz, S, KV, hd)
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    o = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mm)
    x = x + mm(o.transpose(1, 2).reshape(Bsz, S, H * hd), lw["wo"])
    h = _rms(x, lw["norm2"], cfg["norm_eps"])
    return x + mm(F.silu(mm(h, lw["w_gate"])) * mm(h, lw["w_up"]), lw["w_down"])


def _ce_slice(h, head, labels, mm):
    logits = mm(h, head)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).sum()


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """Mean next-token CE of f32 weights ``w`` (flat names, layers stacked)
    on tokens (B, S)."""
    Bsz, S = tokens.shape
    hd = cfg["head_dim"]
    freqs = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, device=tokens.device,
                                                       dtype=torch.float32) / hd))
    ang = torch.arange(S, device=tokens.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = w["table"][tokens]
    for li in range(cfg["n_layers"]):
        lw = {k: w[k][li] for k in LAYER_LEAVES}
        x = checkpoint(_layer, x, lw, cos, sin, cfg, mm, use_reentrant=False)
    h = _rms(x, w["final_norm"], cfg["norm_eps"])[:, :S - 1]
    head = w["table"][:cfg["vocab_size"]].T
    labels = tokens[:, 1:]
    total = sum(checkpoint(_ce_slice, h[:, i:i + CE_CHUNK], head, labels[:, i:i + CE_CHUNK], mm,
                           use_reentrant=False) for i in range(0, S - 1, CE_CHUNK))
    return total / (Bsz * (S - 1))


def leaf_norms(w: Dict[str, torch.Tensor], prefix: str) -> Dict[str, float]:
    """Norms a leaf: each layer's slice of a layer leaf, the table, the final norm."""
    out = {}
    for k, t in w.items():
        if k in LAYER_LEAVES:
            for li, n in enumerate(t.float().flatten(1).norm(dim=1).tolist()):
                out[f"{prefix}{k}/{li}"] = n
        else:
            out[f"{prefix}{k}"] = float(t.float().norm())
    return out


def run(cfg: dict, mix: dict, seed: int, batches: List[torch.Tensor], device,
        steps: int = 3, precision: str = "float32", fault: Optional[str] = None) -> dict:
    """``batches[i]``: step i's tokens (R, B, S). Returns the numbers
    ``compare.checks`` takes."""
    R, lr, alpha = mix["replicas"], mix["lr"], mix["alpha"]
    mm = make_mm(precision)
    dtype = DTYPES[cfg["dtype"]]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        losses = [[0.0] * R for _ in range(steps)]
        grad: Dict[str, float] = {}
        finals = []
        for r in range(R):
            p = data.lm_weights(cfg, seed, device, dtype)
            m = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in p.items()}
            v = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in p.items()}
            for t in range(steps):
                w = {k: x.float().requires_grad_() for k, x in p.items()}
                toks = batches[t][r]
                if fault == "half_batch":
                    toks = toks[:toks.shape[0] // 2]
                lv = loss(w, toks, cfg, mm)
                g = torch.autograd.grad(lv, list(w.values()))
                losses[t][r] = float(lv.detach())
                del w, lv
                if t == 0:
                    grad.update(leaf_norms(dict(zip(p, g)), f"r{r}/"))
                c1, c2 = 1 - B1 ** (t + 1), 1 - B2 ** (t + 1)
                with torch.no_grad():
                    for k, gk in zip(p, g):
                        m[k].mul_(B1).add_((1 - B1) * gk)
                        v[k].mul_(B2).add_((1 - B2) * gk * gk)
                        upd = (m[k] / c1) * torch.rsqrt(v[k] / c2 + EPS * EPS)
                        p[k].sub_((lr * upd).to(p[k].dtype))
                del g
            del m, v
            finals.append(p)
        init = data.lm_weights(cfg, seed, device, dtype)
        with torch.no_grad():
            ps = {k: t.clone() for k, t in init.items()}
            if fault != "no_sync":
                for p in finals:
                    for k in p:
                        ps[k] = ((1 - alpha) * ps[k].float() + alpha * p[k].float()).to(ps[k].dtype)
                        p[k] = ((1 - alpha) * p[k].float() + alpha * ps[k].float()).to(p[k].dtype)
            change = {}
            for r, p in enumerate(finals):
                change.update(leaf_norms({k: p[k].float() - init[k].float() for k in p}, f"r{r}/"))
            change.update(leaf_norms({k: ps[k].float() - init[k].float() for k in ps}, "ps/"))
        return {"losses": [x for row in losses for x in row], "grad": grad, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def grad_of(name: str) -> str:
    """The first-gradient leaf a change leaf is judged by (the PS's by replica 0's)."""
    return "r0/" + name[3:] if name.startswith("ps/") else name
