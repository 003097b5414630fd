"""Plain PyTorch reference of the DLRM cohort's first training steps.

R trainers of M Hogwild threads share one packed embedding table; each
trainer has its own dense replica. An iteration looks every thread's bags
up from the pre-update tables (sum pooling), takes each thread's BCE
gradient of the bottom MLP -> dot interaction -> top MLP at its trainer's
weights, applies the M gradients one after another through Adagrad, then
applies every occurrence's gradient to the table by row-sparse Adagrad
(every g^2 lands before any row steps). Shadow EASGD: replica i's clock
fires at the end of iteration t when (t + 1 + off_i) % gap == 0, off_i =
(i * gap) // R; a fired replica's weights are snapshotted then, and
``delay`` iterations later the PS moves toward the snapshot and the replica
(as it is then) toward the moved PS. A run boundary drops a launch still in
flight. Written from the paper's description (arXiv:1906.00091,
arXiv:2003.03477) in float32, TF32 off; ``precision="tf32"`` is the
control (every product's operands rounded to TF32 first), ``fault``
plants one of the faults the check must catch.

Returns the numbers ``compare.checks`` takes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import data, lowp


def _mm(a, b, precision):
    return lowp.mm(a, b, lowp.tf32) if precision == "tf32" else a @ b


def _mlp(layers, x, final_linear, precision):
    for i, lp in enumerate(layers):
        x = _mm(x, lp["w"], precision) + lp["b"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def _forward(w, dense, pooled, precision):
    bot = _mlp(w["bottom"], dense, False, precision)
    z = torch.cat([bot[:, None, :], pooled], dim=1)
    dots = _mm(z, z.transpose(1, 2), precision)
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1, device=z.device)
    return _mlp(w["top"], torch.cat([bot, dots[:, iu, ju]], dim=1), True, precision)[:, 0]


def _bce(logits, labels):
    return (logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()


def _leaves(tree, prefix):
    out = {}
    for part in ("bottom", "top"):
        for i, lp in enumerate(tree[part]):
            for k in ("b", "w"):
                out[f"{prefix}{part}/{i}/{k}"] = lp[k]
    return out


def _lerp(a, b, alpha):
    return (1.0 - alpha) * a + alpha * b


@torch.no_grad()
def run(cfg: dict, mix: dict, seed: int, device, steps: int = 3,
        boundaries: tuple = (1, 3), precision: str = "float32",
        fault: Optional[str] = None) -> dict:
    R, M, B = mix["trainers"], mix["threads"], mix["batch_per_thread"]
    lr, emb_lr, eps = mix["lr"], mix["emb_lr"], 1e-8
    alpha, gap, delay = mix["alpha"], mix["sync_gap"], mix["sync_delay"]
    F, m, d = cfg["n_sparse_features"], cfg["multi_hot"], cfg["embedding_dim"]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        teacher = data.make_teacher(cfg, seed, device)
        w0 = data.dlrm_dense(cfg, seed, device)
        table = data.dlrm_table(cfg, seed, device)
        acc = torch.zeros_like(table)
        ws = [{p: tuple({k: v.clone() for k, v in lp.items()} for lp in w0[p]) for p in w0}
              for _ in range(R)]
        opt = [{p: tuple({k: torch.zeros_like(v) for k, v in lp.items()} for lp in w0[p])
                for p in w0} for _ in range(R)]
        ps = {p: tuple({k: v.clone() for k, v in lp.items()} for lp in w0[p]) for p in w0}
        offs = torch.arange(R) * gap // R
        offsets = torch.as_tensor(data.offsets(cfg), device=device)[None, :, None]
        batches = [data.ctr_batch(cfg, teacher, seed, t, R * M * B) for t in range(steps)]
        touched = torch.unique(torch.cat([(b["sparse"] + offsets).reshape(-1).long()
                                          for b in batches]))
        rows0 = table[touched].clone()  # the touched rows as drawn
        losses: List[float] = []
        grad: Dict[str, float] = {}
        pending = None
        for t, b in enumerate(batches):
            rows = (b["sparse"] + offsets).long()  # (n, F, m)
            pooled = table[rows].sum(2).reshape(R, M, B, F, d)
            dense = b["dense"].reshape(R, M, B, -1)
            labels = b["labels"].reshape(R, M, B)
            g_pooled = torch.zeros_like(pooled)
            total = 0.0
            for r in range(R):
                grads = []
                for j in range(M):
                    live = {p: tuple({k: v.detach().requires_grad_() for k, v in lp.items()}
                                     for lp in ws[r][p]) for p in ws[r]}
                    pj = pooled[r, j].detach().requires_grad_()
                    keep = B // 2 if fault == "half_batch" else B
                    with torch.enable_grad():
                        loss = _bce(_forward(live, dense[r, j, :keep], pj[:keep], precision),
                                    labels[r, j, :keep])
                        leaves = list(_leaves(live, "").values())
                        g = torch.autograd.grad(loss, leaves + [pj])
                    total += float(loss)
                    grads.append(g[:-1])
                    g_pooled[r, j] = g[-1]
                names = list(_leaves(ws[r], "").keys())
                for gj in grads:  # one after another, from the same weights
                    w_l, a_l = _leaves(ws[r], ""), _leaves(opt[r], "")
                    for n, gg in zip(names, gj):
                        a_l[n].add_(gg * gg)
                        w_l[n].sub_(lr * gg * torch.rsqrt(a_l[n] + eps))
                if t == 0:
                    for n, a in _leaves(opt[r], f"r{r}/").items():
                        grad[n] = math.sqrt(float(a.sum()))
            losses.append(total / (R * M))
            flat = rows.reshape(-1)
            gg = g_pooled.reshape(-1, F, 1, d).expand(-1, F, m, d).reshape(-1, d)
            acc.index_add_(0, flat, gg * gg)
            table.index_add_(0, flat, -emb_lr * torch.rsqrt(acc[flat] + eps) * gg)
            if t == 0:
                grad["table"] = math.sqrt(float(acc.sum()))
            # shadow EASGD: land first, then launch
            if pending is not None and t + 1 >= pending[0]:
                for i, snap in pending[1]:
                    if fault == "no_sync":
                        continue
                    for n, s in _leaves(snap, "").items():
                        p_l, w_l = _leaves(ps, ""), _leaves(ws[i], "")
                        p_l[n].copy_(_lerp(p_l[n], s, alpha))
                        w_l[n].copy_(_lerp(w_l[n], p_l[n], alpha))
                pending = None
            if t + 1 in boundaries:
                pending = None  # a run's end drops the launch in flight
                continue
            fired = [int(i) for i in torch.nonzero((t + 1 + offs) % gap == 0)]
            if pending is None and fired:
                snaps = [(i, {p: tuple({k: v.clone() for k, v in lp.items()} for lp in ws[i][p])
                              for p in ws[i]}) for i in fired]
                pending = (t + 1 + delay, snaps)
        change = {}
        for r in range(R):
            now, was = _leaves(ws[r], f"r{r}/"), _leaves(w0, f"r{r}/")
            change.update({n: float((now[n] - was[n]).norm()) for n in now})
        now, was = _leaves(ps, "ps/"), _leaves(w0, "ps/")
        change.update({n: float((now[n] - was[n]).norm()) for n in now})
        change["table"] = float((table[touched] - rows0).norm())
        return {"losses": losses, "grad": grad, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
