"""Mixture-of-Experts layer: a top-k router and a sort-based dispatch into an
(E, C, d) expert buffer, the port's copy of ``repro/models/moe.py``. No
(T, E, C) one-hot tensor is made.

Tokens are routed in G groups aligned with the data-parallel sharding, G
the product of the active mesh context's batch axes (``_n_groups``), so
that each group's argsort runs over its own shard's tokens. With no mesh
G is 1: every token routed at once, as the reference's one group with no
mesh; the same code path, whose constraints are then the identity. On a
device mesh (DTensor inputs) the dispatch and the un-route of each group
run on its rank's local groups (``local_map``), the (G, E, C/G, d) -> (E,
C, d) regroup between them is the expert-parallel exchange (an
all-to-all), and the reference's constraints place every buffer. The
reference's out-of-bounds scatter (``mode="drop"``) writes to one dump
row past the buffer, and its out-of-bounds gather (``mode="fill"``) reads
a zero row there. Its scatter-add un-route becomes a permutation back to
the (T, k) slots and a sum over k in order: the result does not depend on
the order in which a device's atomics land.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import Params, dense_init, swiglu, swiglu_init
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.ctx import constrain


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


def _n_groups(T: int) -> int:
    """Dispatch groups = data-parallel shards (1 when no mesh context): the
    product of the context's batch axes, halved until it divides ``T``."""
    ctx = shctx.active()
    if ctx is None:
        return 1
    shape = mesh_shape(ctx.mesh)
    g = 1
    for a in ctx.batch_axes:
        g *= shape[a]
    while g > 1 and T % g:
        g //= 2
    return max(g, 1)


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


def _stack(ts):
    """The groups' tensors stacked (one group: a view, no copy)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _route_groups(xt, idx, n_experts: int, k: int, cap: int, dtype):
    """Each local group's expert buffer and its dispatch: xt (g, Tg, d), idx
    (g, Tg, k) -> the buffers (g, E, cap, d) and (order, dest, keep), (g,
    Tg * k) each. A buffer's rows in the stable sort by expert; a slot past
    the capacity writes the dump row past the buffer, which is cut off."""
    bufs, route = [], []
    for x_g, idx_g in zip(xt, idx):
        Tg, d = x_g.shape
        order, dest, keep = _dispatch_indices(idx_g.reshape(-1), n_experts, cap)
        tok_sorted = (torch.arange(Tg * k, device=x_g.device) // k)[order]
        xs = torch.where(keep[:, None], x_g[tok_sorted], 0).to(dtype)
        buf = torch.zeros((n_experts * cap + 1, d), dtype=dtype, device=x_g.device)
        bufs.append(buf.index_put((dest,), xs)[:-1].reshape(n_experts, cap, d))
        route.append((order, dest, keep))
    return (_stack(bufs), *(_stack(r) for r in zip(*route)))


def _unroute_groups(out_g, gates, order, dest, keep, n_experts: int, k: int, cap: int, dtype):
    """Each local group's output rows: out_g (g, E * cap, d) -> (g, Tg, d),
    by the dispatch of ``_route_groups``: a dropped slot reads the zero row
    past the buffer, each row is weighted by its gate, put back in (token,
    slot) order, and the k slots are summed in order."""
    ys = []
    for out, gates_g, order_g, dest_g, keep_g in zip(out_g, gates, order, dest, keep):
        Tg, d = gates_g.shape[0], out.shape[-1]
        gate_sorted = gates_g.reshape(-1)[order_g]
        out = torch.cat([out, out.new_zeros((1, d))])
        y_sorted = out[dest_g] * (gate_sorted[:, None].to(dtype) * keep_g[:, None])
        slots = torch.empty_like(y_sorted).index_copy_(0, order_g, y_sorted).reshape(Tg, k, d)
        y = slots[:, 0]
        for j in range(1, k):
            y = y + slots[:, j]
        ys.append(y)
    return _stack(ys)


def moe_apply(p: Params, x: torch.Tensor, cfg, *, capacity_factor: float = None):
    """x: (B, S, d). Returns (y, aux_loss), the Switch-style load-balance
    loss over all tokens. Tokens route in G groups (``_n_groups``); on
    DTensors each group is dispatched and un-routed on the rank that holds
    it (``local_map``) and the experts are sharded over "model" (the
    reference's lines 62-131)."""
    from torch.distributed.tensor import DTensor

    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.n_experts
    G = _n_groups(T)
    Tg = T // G
    cap = capacity(cfg, Tg, capacity_factor)
    xt = constrain(x.reshape(G, Tg, d), ("batch", None, None))
    probs, gates, idx = route(p, xt, k)  # (G, Tg, E), (G, Tg, k) x2
    # the one-hot sums as comparisons: the same 0/1 counts
    assign = (idx[..., None] == torch.arange(E, device=x.device)).float().sum(dim=2)
    frac_tokens = assign.mean(dim=(0, 1)) / k
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * m.load_balance_coef

    def local(fn, n_out, *args):
        """``fn`` on each rank's groups (every output sharded as ``xt``)."""
        if not isinstance(xt, DTensor):
            return fn(*args, E, k, cap, x.dtype)
        from torch.distributed.tensor.experimental import local_map

        return local_map(lambda *a: fn(*a, E, k, cap, x.dtype),
                         out_placements=(xt.placements,) * n_out,
                         in_placements=tuple(t.placements for t in args),
                         device_mesh=xt.device_mesh)(*args)

    buf_g, *route_state = local(_route_groups, 4, xt, idx)
    buf_g = constrain(buf_g, ("batch", None, None, None))
    # group-major -> expert-major: the expert-parallel exchange
    buf = constrain(buf_g.transpose(0, 1).reshape(E, G * cap, d), ("model", "batch", None))
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = constrain(torch.bmm(h, p["w_down"]), ("model", "batch", None))
    out_g = constrain(out.reshape(E, G, cap, d).transpose(0, 1), ("batch", None, None, None))
    y = local(_unroute_groups, 1, out_g.reshape(G, E * cap, d), gates, *route_state)
    y = constrain(y, ("batch", None, None)).reshape(B, S, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], xt.reshape(T, d)).reshape(B, S, d)
    return y, aux
