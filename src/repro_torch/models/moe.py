"""Mixture-of-Experts layer: a top-k router and a sort-based dispatch into an
(E, C, d) expert buffer, the port's copy of ``repro/models/moe.py``. No
(T, E, C) one-hot tensor is made.

The reference routes in groups, one a data-parallel shard, so that its
argsort never crosses a shard; the port has no mesh (ROADMAP queue 1,
'sharding, dry run, mesh and roofline'), so it routes every token at once,
as the reference's one group does with no mesh. Its
out-of-bounds scatter (``mode="drop"``) writes to one dump row past the
buffer, and its out-of-bounds gather (``mode="fill"``) reads a zero row
there. Its scatter-add un-route becomes a permutation back to the (T, k)
slots and a sum over k in order: the result does not depend on the order
in which a device's atomics land.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, swiglu, swiglu_init


def moe_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    """The router in f32, the experts' weights (E, d, f) and (E, f, d) in
    ``dtype``, Normal * d_in**-0.5 drawn on ``gen``'s device; a SwiGLU of
    width ``d_ff_expert * n_shared_experts`` for the shared experts."""
    m = cfg.moe
    E, d, f = m.n_experts, cfg.d_model, m.d_ff_expert

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
        return (w * d_in ** -0.5).to(device=device, dtype=dtype)

    p = {
        "router": dense_init(gen, d, E, torch.float32, device=device),
        "w_gate": experts(d, f),
        "w_up": experts(d, f),
        "w_down": experts(f, d),
    }
    if m.n_shared_experts:
        def draw(d_in, d_out, dt, scale=None):
            return dense_init(gen, d_in, d_out, dt, scale=scale, device=device)

        p["shared"] = swiglu_init(draw, d, f * m.n_shared_experts, dtype)
    return p


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """expert_idx: (Tk,) local expert assignment. Returns (order, dest, keep):
    the stable sort by expert, each sorted slot's row of the (E * capacity)
    buffer, and whether it fits; a slot that does not fit has row
    ``n_experts * capacity`` (the dump row)."""
    order = torch.argsort(expert_idx, stable=True)
    e_sorted = expert_idx[order]
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(e_sorted.shape[0], device=e_sorted.device) - first
    keep = pos < capacity
    dest = torch.where(keep, e_sorted * capacity + pos, n_experts * capacity)
    return order, dest, keep


def route(p: Params, xt: torch.Tensor, k: int):
    """The router: (probs, gates, idx) of tokens xt (..., d); the top-k
    gates renormalised to sum to 1."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def capacity(cfg, n_tokens: int, capacity_factor: float = None) -> int:
    """The expert capacity for ``n_tokens`` routed at once:
    ``int(max(k, cf * T * k / E))``, the reference's Python float
    arithmetic."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    return int(max(m.top_k, cf * n_tokens * m.top_k / m.n_experts))


def _dispatch_experts(p, xt, gates, idx, cfg, cap, dtype):
    """The dispatch and the expert products. xt: (T, d); gates, idx:
    (T, k). Returns the experts' output (T, d)."""
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    T, d = xt.shape
    order, dest, keep = _dispatch_indices(idx.reshape(-1), E, cap)
    tok_sorted = (torch.arange(T * k, device=xt.device) // k)[order]
    gate_sorted = gates.reshape(-1)[order]
    xs = torch.where(keep[:, None], xt[tok_sorted], 0).to(dtype)
    buf = torch.zeros((E * cap + 1, d), dtype=dtype, device=xt.device)  # + the dump row
    buf = buf.index_put((dest,), xs)  # dropped slots all write the dump row, zeros
    buf = buf[:-1].reshape(E, cap, d)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"]).reshape(E * cap, d)
    out = torch.cat([out, out.new_zeros((1, d))])  # a dropped slot reads zeros
    y_sorted = out[dest] * (gate_sorted[:, None].to(dtype) * keep[:, None])
    # un-route: back to (token, slot) order, then the k slots summed in order
    slots = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted).reshape(T, k, d)
    y = slots[:, 0]
    for j in range(1, k):
        y = y + slots[:, j]
    return y


def moe_apply(p: Params, x: torch.Tensor, cfg, *, capacity_factor: float = None):
    """x: (B, S, d). Returns (y, aux_loss), the Switch-style load-balance
    loss over all tokens."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.n_experts
    cap = capacity(cfg, T, capacity_factor)
    xt = x.reshape(T, d)

    probs, gates, idx = route(p, xt, k)  # (T, E), (T, k) x2
    assign = F.one_hot(idx, E).float().sum(dim=1)  # (T, E)
    frac_tokens = assign.mean(dim=0) / k
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs) * m.load_balance_coef

    y = _dispatch_experts(p, xt, gates, idx, cfg, cap, x.dtype).reshape(B, S, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], xt).reshape(B, S, d)
    return y, aux
