"""Compare every registered sync algorithm, shadow vs fixed-rate (paper
§4.2-4.3 scaled down), on the PyTorch port, on the CUDA card unless
``--device cpu`` is given. The sweep is driven by the algorithm registry.

    PYTHONPATH=src python examples/torch_compare_sync_algorithms.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import optim
from repro_torch.configs import dlrm_ctr
from repro_torch.core import algorithms
from repro_torch.core.runners import HogwildSim
from repro_torch.core.sync import SyncConfig

CFG = dlrm_ctr.tiny()


def run(algo, mode, device, iters, alpha=0.5):
    sim = HogwildSim(CFG, SyncConfig(algo=algo, mode=mode, gap=5, alpha=alpha),
                     n_trainers=4, n_threads=2, batch_size=128,
                     optimizer=optim.adagrad(0.02), device=device)
    out = sim.run(iters)
    ev = sim.evaluate(out["state"], n_batches=8, batch_size=2048)
    return float(np.mean(out["train_loss"][-10:])), ev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--iters", type=int, default=120)
    args = ap.parse_args(argv)

    results = {}
    print(f"{'method':16s} {'train':>8s} {'eval':>8s}")
    for algo in algorithms.names():
        for mode, tag in (("shadow", "S"), ("fixed_rate", "FR")):
            tr, ev = results[(algo, mode)] = run(algo, mode, args.device, args.iters)
            print(f"{f'{tag}-{algo.upper()}':16s} {tr:8.5f} {ev:8.5f}")
    tr, ev = results[("bmuf", "shadow", 0.9)] = run("bmuf", "shadow", args.device, args.iters,
                                                    alpha=0.9)
    print(f"S-BMUF(a=0.9)    {tr:8.5f} {ev:8.5f}  <- larger elastic step (paper Fig 7)")
    return results


if __name__ == "__main__":
    main()
