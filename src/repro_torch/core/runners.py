"""The deterministic training simulator, the twin of ``HogwildSim`` in
``repro/core/runners.py``.

``HogwildSim`` simulates n trainers x m Hogwild worker threads over one
shared packed embedding table and per-trainer dense replicas. Hogwild
staleness: all m thread-gradients of an iteration come from the SAME replica
snapshot and are then applied one after another through the optimizer.
Background sync follows shadow clocks with launch-snapshot / delayed-landing
semantics, or a fixed-rate barrier, and the ``SyncAlgorithm`` fetched from
``core.algorithms`` owns what a sync does.

Each iteration launches the embedding-bag kernel once (the lookup of every
trainer's and thread's bags from the pre-update tables), then the dense
forward/backward and optimizer steps in plain torch, then the sparse-Adagrad
kernel once with every thread's gradient. A landing sync is one launch of
the EASGD round kernel over the flat ``(R, n_rows, 128)`` replica buffer
(``engine="flat"``, the default); ``engine="pytree"`` runs the tree oracle.

Not yet ported: elastic membership, the tiered cache, step pipelining, mode
switching and checkpoints; passing their options raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import algorithms
from repro_torch.core import sync as S
from repro_torch.core.flatspace import FlatSpace
from repro_torch.data import ctr
from repro_torch.embeddings import table as emb
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dlrm
from repro_torch.optim import Optimizer

Tree = Any


def _dense_flatspace(cfg) -> FlatSpace:
    """Layout of the DLRM dense replica space (from a throwaway CPU init)."""
    return FlatSpace.from_tree(dlrm.init_dense(cfg, torch.Generator()))


def _stack(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


@dataclass
class SimState:
    # Dense replicas: a tree stack with leading R (engine="pytree") or a
    # persistent (R, n_rows, 128) fp32 flat buffer (engine="flat").
    w_stack: Tree
    opt_stack: Tree
    emb_state: Dict[str, torch.Tensor]  # shared {"table", "acc"}
    algo_state: Any  # owned by the SyncAlgorithm (EASGD: the sync-PS copy)
    step: int


class HogwildSim:
    def __init__(
        self,
        cfg,  # DLRMConfig
        sync_cfg: S.SyncConfig,
        *,
        n_trainers: int,
        n_threads: int,
        batch_size: int,
        optimizer: Optimizer,
        emb_lr: float = 0.05,
        seed: int = 0,
        membership=None,
        schedule=None,
        cache=None,
        pipeline=None,
        mode_schedule=None,
        device: Optional[str] = None,
    ):
        unported = dict(membership=membership, schedule=schedule, cache=cache,
                        pipeline=pipeline, mode_schedule=mode_schedule)
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(f"HogwildSim({name}=...) is not yet ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sync_cfg = sync_cfg.validate()
        self.engine = sync_cfg.engine
        self.algo = algorithms.get(sync_cfg.algo)
        self.R, self.M, self.B = n_trainers, n_threads, batch_size
        self.opt = optimizer
        self.emb_lr = emb_lr
        self.seed = seed
        self.spec = emb.spec_from_config(cfg)
        self.teacher = ctr.make_teacher(cfg, seed=seed + 777, device=self.device)
        self.flat = _dense_flatspace(cfg) if self.engine == "flat" else None

    # -- one training iteration ------------------------------------------------
    def _dense_core(self, w: Tree, opt_state: Tree, pooled: torch.Tensor, batch):
        """Everything downstream of the lookup. ``w``: the (R, ...) replica
        stack; pooled: (R, M, B, F, d). M thread-gradients per trainer from the
        SAME weights, applied one after another."""
        R, M = self.R, self.M
        w_threads = T.map(lambda x: x.unsqueeze(1).expand((R, M) + tuple(x.shape[1:])), w)
        loss, g_w, g_pooled = dlrm.dense_loss_and_grads(
            w_threads, batch["dense"], pooled, batch["labels"])  # loss: (R, M)
        for j in range(M):
            w, opt_state = self.opt.update(w, opt_state, T.map(lambda g: g[:, j], g_w))
        return w, opt_state, loss.mean(1).mean(0), g_pooled

    def _train_iter(self, st: SimState, batch) -> torch.Tensor:
        cfg, spec = self.cfg, self.spec
        F, m, d = cfg.n_sparse_features, cfg.multi_hot, cfg.embedding_dim
        idx = batch["sparse"].reshape(-1, F, m)
        pooled = emb.lookup(st.emb_state, spec, idx).reshape(self.R, self.M, self.B, F, d)
        w = self.flat.unpack_stack(st.w_stack) if self.engine == "flat" else st.w_stack
        w, st.opt_stack, loss, g_pooled = self._dense_core(w, st.opt_stack, pooled, batch)
        st.w_stack = self.flat.pack_stack(w) if self.engine == "flat" else w
        # Hogwild on the single embedding copy: one fused, in-place
        # scatter-Adagrad launch with every trainer's and thread's gradient.
        emb.sparse_adagrad_update_fused(st.emb_state, spec, idx, g_pooled.reshape(-1, F, d),
                                        self.emb_lr)
        return loss

    # -- state --------------------------------------------------------------
    def init_state(self) -> SimState:
        gen = torch.Generator().manual_seed(self.seed)
        w0 = dlrm.init_dense(self.cfg, gen, device=self.device)
        emb_state = emb.init_tables(self.spec, gen, device=self.device)
        opt0 = self.opt.init(w0)
        opt_stack = T.map(lambda x: _stack(x, self.R), opt0)
        if self.engine == "flat":
            fs = self.flat
            w_stack = fs.broadcast(w0, self.R)  # packed ONCE
            algo_state = self.algo.init_state_flat(fs.pack(w0), self.sync_cfg, fs)
        else:
            w_stack = T.map(lambda x: _stack(x, self.R), w0)
            algo_state = self.algo.init_state(w0, self.sync_cfg)
        return SimState(w_stack, opt_stack, emb_state, algo_state, 0)

    def make_batch(self, it: int) -> Dict[str, torch.Tensor]:
        """One-pass stream: R*M distinct shards per iteration, as (R, M, B, ...)."""
        b = ctr.gen_batch(self.cfg, self.teacher, self.seed, it, self.B * self.R * self.M)
        return {k: v.reshape(self.R, self.M, self.B, *v.shape[1:]) for k, v in b.items()}

    # -- sync scheduling ----------------------------------------------------
    def _shadow_schedule(self, t: int) -> np.ndarray:
        """mask[i]: replica i's shadow clock fires at iteration t (staggered)."""
        gap = self.sync_cfg.gap
        offs = (np.arange(self.R) * gap) // max(self.R, 1)
        return ((t + offs) % gap) == 0

    def _launch_snapshot(self, st: SimState, mask: np.ndarray) -> Any:
        """State captured when a background sync launches (lands ``delay``
        later): the algorithm's compact form on the flat engine, a deep copy
        of the stack on the pytree engine."""
        if self.engine == "flat":
            return self.algo.launch_snapshot_flat(st.w_stack, mask, self.sync_cfg, self.flat,
                                                  st.algo_state)
        return T.map(torch.clone, st.w_stack)

    def _apply_sync(self, st: SimState, snap, mask) -> SimState:
        """Land one sync. ``snap=None``: fixed rate, sync against the current
        state; ``mask=None``: every replica fired."""
        if self.engine == "flat":
            st.w_stack, st.algo_state = self.algo.land_flat(
                st.w_stack, st.algo_state, snap, mask, self.sync_cfg, self.flat)
        else:
            st.w_stack, st.algo_state = self.algo.land(
                st.w_stack, st.algo_state, snap, mask, self.sync_cfg)
        return st

    def run(self, n_iters: int, *, log_every: int = 0,
            on_iter: Optional[Callable[[int, float], None]] = None,
            state: Optional[SimState] = None) -> Dict[str, Any]:
        """Train ``n_iters`` iterations. ``state`` resumes a prior run: the
        iteration numbering (the batch stream, the shadow clocks) continues
        from ``state.step``."""
        st = self.init_state() if state is None else state
        sc = self.sync_cfg
        losses: List[float] = []
        sync_count = 0
        examples = 0
        start = int(st.step)
        # (land_t, snapshot, fired_mask)
        pending: Optional[Tuple[int, Any, np.ndarray]] = None
        for t in range(start, start + n_iters):
            loss = self._train_iter(st, self.make_batch(t))
            losses.append(float(loss))  # synchronises, as float() does in the reference
            examples += self.R * self.M * self.B
            if sc.mode == "fixed_rate":
                if (t + 1) % sc.gap == 0:
                    st = self._apply_sync(st, None, None)
                    sync_count += self.R
            else:  # shadow: land first, then launch
                if pending is not None and t + 1 >= pending[0]:
                    _, snap, mask = pending
                    st = self._apply_sync(st, snap, mask)
                    sync_count += int(mask.sum())
                    pending = None
                if pending is None:
                    mask = self._shadow_schedule(t + 1)
                    if mask.any():
                        if sc.delay == 0:
                            # lands this iteration; no training step intervenes,
                            # so the pytree engine needs no deep copy
                            snap = (self._launch_snapshot(st, mask)
                                    if self.engine == "flat" else st.w_stack)
                            st = self._apply_sync(st, snap, mask)
                            sync_count += int(mask.sum())
                        else:
                            pending = (t + 1 + sc.delay, self._launch_snapshot(st, mask), mask)
            st.step = t + 1
            if on_iter:
                on_iter(t, losses[-1])
            if log_every and (t + 1) % log_every == 0:
                print(f"iter {t+1}: loss {np.mean(losses[-log_every:]):.5f}")
        replica_iters = examples // (self.M * self.B)
        return {
            "state": st,
            "train_loss": losses,
            "sync_count": sync_count,
            "avg_sync_gap": replica_iters / max(sync_count, 1),
            "examples": examples,
        }

    def replica_params(self, st: SimState, i: int) -> Tree:
        """Replica i's dense weights as a tree, whatever the engine."""
        if self.engine == "flat":
            return self.flat.unpack_replica(st.w_stack, i)
        return S.tree_slice(st.w_stack, i)

    @torch.no_grad()
    def evaluate(self, st: SimState, n_batches: int = 20, batch_size: int = 4096,
                 replica: int = 0) -> float:
        """Paper protocol: evaluate the FIRST trainer's replica."""
        w = self.replica_params(st, replica)
        tot = 0.0
        for i in range(n_batches):
            b = ctr.gen_batch(self.cfg, self.teacher, self.seed + 10_000_000, i, batch_size)
            pooled = emb.lookup(st.emb_state, self.spec, b["sparse"])
            tot += float(dlrm.bce_loss(dlrm.forward(w, b["dense"], pooled), b["labels"]))
        return tot / n_batches
