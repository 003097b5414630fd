"""Quickstart on the PyTorch port: train a small DLRM on synthetic CTR data
with Shadow-EASGD, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--iters 150]

Runs the deterministic Hogwild simulator: 4 trainers x 2 Hogwild threads,
one-pass data, background EASGD sync (``examples/quickstart.py``'s run).
"""
import argparse

import numpy as np

from repro_torch import optim
from repro_torch.configs import dlrm_ctr
from repro_torch.core.elp import elp
from repro_torch.core.runners import HogwildSim
from repro_torch.core.sync import SyncConfig

TRAINERS, THREADS, BATCH = 4, 2, 128


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--iters", type=int, default=150)
    args = ap.parse_args(argv)

    cfg = dlrm_ctr.tiny()
    print(f"DLRM: {cfg.n_sparse_features} categorical features, "
          f"{cfg.n_embedding_rows:,} embedding rows, dim {cfg.embedding_dim}")
    print(f"ELP = {BATCH} batch x {THREADS} hogwild x {TRAINERS} trainers "
          f"= {elp(BATCH, THREADS, TRAINERS):,}")

    sim = HogwildSim(
        cfg,
        SyncConfig(algo="easgd", mode="shadow", gap=5, alpha=0.5),
        n_trainers=TRAINERS, n_threads=THREADS, batch_size=BATCH,
        optimizer=optim.adagrad(0.02), device=args.device,
    )
    out = sim.run(args.iters, log_every=25)
    ev = sim.evaluate(out["state"], n_batches=10, batch_size=4096)
    print(f"\ntrain loss: {np.mean(out['train_loss'][:10]):.5f} -> "
          f"{np.mean(out['train_loss'][-10:]):.5f}")
    print(f"eval loss (replica 0, paper protocol): {ev:.5f}")
    print(f"background syncs: {out['sync_count']} "
          f"(avg gap {out['avg_sync_gap']:.2f} iterations)")
    return out, ev


if __name__ == "__main__":
    main()
