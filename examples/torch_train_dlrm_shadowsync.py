"""End-to-end run on the PyTorch port: ~100M-parameter DLRM, a few hundred
ShadowSync steps, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_dlrm_shadowsync.py [--threaded] [--device cpu]

The model: 6.1M embedding rows x dim 16 (~98M embedding params) + MLPs
(``examples/train_dlrm_shadowsync.py``'s). Default runs the deterministic
simulator (4 trainers x 2 threads, 300 one-pass iterations); --threaded runs
the real-thread Algorithm 1 instead (trainer threads + a continuously-syncing
background shadow thread). ``--save`` checkpoints the simulator's final
state in the JAX package's format.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import dlrm_ctr
from repro_torch.core.runners import HogwildSim, ThreadedShadowRunner
from repro_torch.core.sync import SyncConfig

# ~100M params: power-law tables totalling ~6.1M rows x dim 16.
CFG_100M = dataclasses.replace(
    dlrm_ctr.CONFIG,
    embedding_dim=16,
    table_sizes=(3_000_000, 1_500_000, 800_000, 400_000, 200_000, 100_000,
                 50_000, 25_000, 12_000, 6_000, 3_000, 1_000, 500, 200),
    n_sparse_features=14,
    multi_hot=2,
    bottom_mlp=(256, 64, 16),
    top_mlp=(256, 64, 1),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--threaded", action="store_true")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    cfg = CFG_100M
    n_params = cfg.n_embedding_rows * cfg.embedding_dim
    print(f"DLRM with {n_params/1e6:.0f}M embedding params "
          f"({cfg.n_embedding_rows:,} rows), {cfg.n_sparse_features} features")
    sync_cfg = SyncConfig(algo="easgd", mode="shadow", gap=5, alpha=0.5)
    opt = optim.adagrad(0.02)

    t0 = time.perf_counter()
    if args.threaded:
        runner = ThreadedShadowRunner(cfg, sync_cfg, n_trainers=3, batch_size=128,
                                      optimizer=opt, sync_sleep_s=0.005, device=args.device)
        out = runner.run(args.iters)
        print(f"EPS (real wall clock) = {out['eps']:.0f}; "
              f"avg sync gap {out['avg_sync_gap']:.3f}; "
              f"losses {[round(l, 4) for l in out['train_loss']]}")
        return out
    sim = HogwildSim(cfg, sync_cfg, n_trainers=4, n_threads=2, batch_size=128,
                     optimizer=opt, device=args.device)
    out = sim.run(args.iters, log_every=50)
    ev = sim.evaluate(out["state"], n_batches=10, batch_size=4096)
    print(f"train {np.mean(out['train_loss'][:10]):.5f} -> "
          f"{np.mean(out['train_loss'][-10:]):.5f}; eval {ev:.5f}; "
          f"{args.iters} iters in {time.perf_counter()-t0:.0f}s")
    if args.save:
        st = out["state"]
        ckpt.save(args.save, {"w": st.w_stack, "emb": st.emb_state},
                  metadata={"step": st.step})
        print("checkpoint saved to", args.save)
    return out


if __name__ == "__main__":
    main()
