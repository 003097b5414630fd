"""Training launcher for the port: ``dlrm`` runs the deterministic
``HogwildSim`` (n trainers x m Hogwild threads on synthetic CTR, shadow or
fixed-rate sync) on the CUDA card unless ``--device cpu`` is given.

  python -m repro_torch.launch.train dlrm --full --iters 50
  python -m repro_torch.launch.train dlrm --device cpu --tiny --iters 20

The flags are the JAX launcher's (``repro/launch/train.py dlrm``). Those of
parts not yet ported (``--threaded`` and its fault injections, the cache,
pipelining, membership schedules, checkpoints, ``--auto-*``) raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import optim
from repro_torch.configs import dlrm_ctr
from repro_torch.core import algorithms
from repro_torch.core.elp import elp
from repro_torch.core.runners import HogwildSim
from repro_torch.core.sync import SyncConfig


def _unported(args) -> list:
    flags = {
        "--threaded": args.threaded,
        "--cache-rows": args.cache_rows is not None,
        "--pipeline-depth > 1": args.pipeline_depth > 1,
        "--membership-schedule": args.membership_schedule is not None,
        "--save": args.save is not None,
        "--restore": args.restore is not None,
        "--auto-demote": args.auto_demote,
        "--auto-mode": args.auto_mode,
        "--crash-at/--join-at/--straggler/--raise-at/--sync-crash-at/--sync-stall-at/"
        "--ps-fail-at": any(v is not None for v in (
            args.crash_at, args.join_at, args.straggler, args.straggler_until, args.raise_at,
            args.sync_crash_at, args.sync_stall_at, args.ps_fail_at)),
    }
    return [name for name, on in flags.items() if on]


def run_dlrm(args) -> dict:
    unported = _unported(args)
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not yet ported to repro_torch")
    if args.pipeline_depth < 1:
        raise SystemExit(f"--pipeline-depth must be >= 1, got {args.pipeline_depth}")
    cfg = dlrm_ctr.tiny(embedding_dim=args.embedding_dim) if args.tiny else dlrm_ctr.CONFIG
    sync_cfg = SyncConfig(algo=args.algo, mode=args.mode or "shadow", gap=args.sync_gap,
                          alpha=args.alpha, delay=args.sync_delay)
    sim = HogwildSim(cfg, sync_cfg, n_trainers=args.trainers, n_threads=args.threads,
                     batch_size=args.batch_size, optimizer=optim.make(args.optimizer, args.lr),
                     seed=args.seed, device=args.device)
    print(f"DLRM {'tiny' if args.tiny else 'full'} on {sim.device}: "
          f"{cfg.n_sparse_features} sparse features, {cfg.n_embedding_rows:,} embedding rows; "
          f"ELP = {elp(args.batch_size, args.threads, args.trainers):,}")
    st0 = sim.init_state()
    t0 = time.perf_counter()
    out = sim.run(args.iters, log_every=args.log_every, state=st0)
    wall = time.perf_counter() - t0
    ev = sim.evaluate(out["state"], n_batches=args.eval_batches)
    print(f"train loss {np.mean(out['train_loss'][:10]):.5f} -> "
          f"{np.mean(out['train_loss'][-10:]):.5f}; eval {ev:.5f}; "
          f"avg_sync_gap {out['avg_sync_gap']:.2f}; EPS(sim wall) {out['examples'] / wall:.0f}")
    return {"final_train": float(np.mean(out["train_loss"][-10:])), "eval": ev,
            "avg_sync_gap": out["avg_sync_gap"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dlrm")
    d.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    d.add_argument("--algo", choices=list(algorithms.names()), default="easgd")
    d.add_argument("--mode", choices=["shadow", "fixed_rate"], default=None,
                   help="pin the sync mode (default shadow)")
    d.add_argument("--trainers", type=int, default=4)
    d.add_argument("--threads", type=int, default=4)
    d.add_argument("--batch-size", type=int, default=128)
    d.add_argument("--iters", type=int, default=200)
    d.add_argument("--sync-gap", type=int, default=5)
    d.add_argument("--sync-delay", type=int, default=1)
    d.add_argument("--sync-sleep", type=float, default=0.0)
    d.add_argument("--alpha", type=float, default=0.5)
    d.add_argument("--lr", type=float, default=0.02)
    d.add_argument("--optimizer", default="adagrad", choices=sorted(optim.REGISTRY))
    d.add_argument("--embedding-dim", type=int, default=16)
    d.add_argument("--tiny", action="store_true", default=True)
    d.add_argument("--full", dest="tiny", action="store_false")
    d.add_argument("--eval-batches", type=int, default=10)
    d.add_argument("--log-every", type=int, default=50)
    d.add_argument("--seed", type=int, default=0)
    # Flags of parts not yet ported: accepted as in the JAX launcher, then refused.
    d.add_argument("--threaded", action="store_true")
    d.add_argument("--save", default=None)
    d.add_argument("--restore", default=None)
    d.add_argument("--membership-schedule", default=None)
    for flag in ("--crash-at", "--join-at", "--straggler", "--straggler-until", "--raise-at",
                 "--ps-fail-at"):
        d.add_argument(flag, default=None)
    d.add_argument("--sync-crash-at", type=int, default=None)
    d.add_argument("--sync-stall-at", type=int, default=None)
    d.add_argument("--sync-stall-s", type=float, default=10.0)
    d.add_argument("--ps-recover-after", type=float, default=0.25)
    d.add_argument("--auto-demote", action="store_true")
    d.add_argument("--eps-floor", type=float, default=0.5)
    d.add_argument("--probation", type=float, default=1.0)
    d.add_argument("--auto-mode", action="store_true")
    d.add_argument("--skew-high", type=float, default=2.0)
    d.add_argument("--skew-low", type=float, default=1.3)
    d.add_argument("--mode-dwell", type=float, default=2.0)
    d.add_argument("--mode-window", type=float, default=0.5)
    d.add_argument("--cache-rows", type=int, default=None)
    d.add_argument("--lookahead", type=int, default=2)
    d.add_argument("--pipeline-depth", type=int, default=1)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    out = run_dlrm(args)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
